"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package ``repro``, and its entry points run on the GPU unless the caller
asks for the CPU explicitly.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["repro"] = None        # ... and of the JAX package
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
"""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not IMPORT_RE.search(path.read_text()), path


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


def test_kernel_wrappers_take_plain_version_on_cpu():
    import torch
    from repro_torch.kernels.colbert_maxsim.ops import (
        colbert_maxsim_multi_op)
    from repro_torch.kernels.maxsim_top2.ops import maxsim_top2_op
    from repro_torch.kernels.maxsim_topk.ops import maxsim_topk_op
    before = (maxsim_top2_op.launches, maxsim_topk_op.launches,
              colbert_maxsim_multi_op.launches)
    s, t = torch.randn(8, 4), torch.randn(2, 6, 4)
    a = torch.ones(2, 6, dtype=torch.bool)
    maxsim_top2_op(s, t, a)
    maxsim_topk_op(s, t, a, k=3)
    colbert_maxsim_multi_op(torch.randn(2, 3, 4), t, a)
    assert (maxsim_top2_op.launches, maxsim_topk_op.launches,
            colbert_maxsim_multi_op.launches) == before
