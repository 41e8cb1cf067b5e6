"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package ``repro`` (nor ``msgpack`` or ``ml_dtypes``, and ``zstandard``
only inside the function that reads a zstd checkpoint), and its entry
points run on the GPU unless the caller asks for the CPU explicitly.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(jax|repro|msgpack|ml_dtypes)(\.|\s|$)", re.M)
MODULE_IMPORT_RE = re.compile(r"^(import|from)\s+zstandard(\.|\s|$)", re.M)

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["repro"] = None        # ... and of the JAX package
for name in ("msgpack", "zstandard", "ml_dtypes"):   # absent on the card
    sys.modules[name] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
print("imported", len(names))

import torch
from repro_torch.launch.serve import serve_retrieval
from repro_torch.configs import colbert_base
assert not torch.cuda.is_available()
try:
    serve_retrieval(colbert_base.SMOKE, n_queries=2, n_docs=8)
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
    print("raised without cuda")
else:
    raise SystemExit("entry point ran without CUDA and without device='cpu'")
res = serve_retrieval(colbert_base.SMOKE, n_queries=2, n_docs=8,
                      device="cpu")
assert res.idx.shape == (2, 8), res.idx.shape
print("cpu ok")

from repro_torch.launch import serve as serve_cli
from repro_torch.serve.loop import ServeLoop
try:
    serve_cli.main(["--serve-loop"])
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
    print("serve cli raised without cuda")
else:
    raise SystemExit("the serve CLI ran without CUDA and without --device cpu")
with ServeLoop(res.server, flush_ms=1.0) as loop:
    one = loop.query(res.q_emb[0])
assert one.top_idx.shape == (8,) and (one.top_idx == res.idx[0]).all()
print("serve loop cpu ok")

from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.serve.retrieval import topk_search
from repro_torch.sharding import axis_rules, serve_rules
for hosts in (1, 2):
    with axis_rules(serve_rules(make_serve_mesh(hosts, ["cpu"] * 4))):
        got = topk_search(res.packed, res.q_emb, k=4)
    want = topk_search(res.packed, res.q_emb, k=4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
print("mesh cpu ok")

from repro_torch.configs import dlrm_rm2
from repro_torch.launch.serve import serve_ctr
try:
    serve_ctr(dlrm_rm2.SMOKE, 4)
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
    print("serve_ctr raised without cuda")
else:
    raise SystemExit("serve_ctr ran without CUDA and without device='cpu'")
probs, _ = serve_ctr(dlrm_rm2.SMOKE, 4, device="cpu")
assert probs.shape == (4,), probs.shape
print("serve_ctr cpu ok")

import tempfile
from repro_torch.launch import train
from repro_torch.train import checkpoint
try:
    train.run("colbert", steps=1, batch=2, log_every=0)
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
    print("train raised without cuda")
else:
    raise SystemExit("train.run ran without CUDA and without device='cpu'")
with tempfile.TemporaryDirectory() as d:
    out = train.run("colbert", steps=2, batch=2, log_every=0, ckpt_dir=d,
                    ckpt_every=1, device="cpu")
    step, tree = checkpoint.restore_latest(d, {"w": torch.zeros(1)})
    assert step is None     # the leaves are a train state's, not {"w"}
    checkpoint.save(d, 9, {"w": torch.ones(3, dtype=torch.bfloat16)})
    step, tree = checkpoint.restore_latest(d, {"w": torch.zeros(3)})
    assert step == 9 and tree["w"].dtype == torch.bfloat16, tree
print("train and checkpoint cpu ok")
"""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    text = path.read_text()
    assert not IMPORT_RE.search(text), path
    assert not MODULE_IMPORT_RE.search(text), path


def test_port_imports_and_runs_with_jax_blocked():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; this host has a GPU")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised without cuda" in out.stdout
    assert "cpu ok" in out.stdout
    assert "serve cli raised without cuda" in out.stdout
    assert "serve loop cpu ok" in out.stdout
    assert "mesh cpu ok" in out.stdout
    assert "serve_ctr raised without cuda" in out.stdout
    assert "serve_ctr cpu ok" in out.stdout
    assert "train raised without cuda" in out.stdout
    assert "train and checkpoint cpu ok" in out.stdout


def test_kernel_wrappers_take_plain_version_on_cpu():
    import torch
    from repro_torch.kernels.colbert_maxsim.ops import (
        colbert_maxsim_multi_op)
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
    from repro_torch.kernels.maxsim_top2.ops import maxsim_top2_op
    from repro_torch.kernels.maxsim_topk.ops import maxsim_topk_op
    before = (maxsim_top2_op.launches, maxsim_topk_op.launches,
              colbert_maxsim_multi_op.launches, embedding_bag_op.launches)
    s, t = torch.randn(8, 4), torch.randn(2, 6, 4)
    a = torch.ones(2, 6, dtype=torch.bool)
    maxsim_top2_op(s, t, a)
    maxsim_topk_op(s, t, a, k=3)
    colbert_maxsim_multi_op(torch.randn(2, 3, 4), t, a)
    embedding_bag_op(torch.randn(8, 4), torch.zeros(3, 2, dtype=torch.int32))
    assert (maxsim_top2_op.launches, maxsim_topk_op.launches,
            colbert_maxsim_multi_op.launches,
            embedding_bag_op.launches) == before
