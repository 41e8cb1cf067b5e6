"""The port's serving CLI (``repro_torch.launch.serve``) on the CPU.

* Every argv of ``tests/test_serve_cli.py`` (and a few more) goes
  through both packages' ``parse_args``: the same accept or reject, the
  same error message (program name and package prefix aside), and for
  an accepted argv the same namespace apart from the port's ``device``.
* ``main([..., "--device", "cpu"])`` runs the serving loop's leg, the
  mutation lifecycle, routing and ``--ckpt-dir`` (a checkpoint of the
  port's ``launch.train``, one step at the smoke config): the served
  top-10 equals ``serve_retrieval(model=...)`` of the restored encoder,
  and a directory without a valid train checkpoint raises.
* The grid legs (``--mesh host|grid``, ``--hosts``, ``--replicas``,
  ``--on-group-loss``, ``--kill-group``) are in
  ``test_torch_serve_cli_grid.py``, a file of their own so that a
  worker of ``--dist loadfile`` takes them apart from these.
* An arch the port lacks raises ``NotImplementedError`` naming its
  ROADMAP item; without ``--device`` the CLI raises where there is no
  GPU.
"""

import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro_torch.configs import colbert_base
from repro_torch.launch import serve
from repro_torch.launch import train as train_lib
from repro_torch.train import checkpoint

REJECTS = [
    (["--kill-group", "1"], "--mesh grid"),
    (["--kill-group", "0", "--mesh", "host"], "--mesh grid"),
    (["--replicas", "2"], "mesh"),
    (["--upsert", "4"], "--index-dir"),
    (["--delete", "1,2"], "--index-dir"),
    (["--compact"], "--index-dir"),
    (["--upsert", "4", "--index-dir", "x", "--mesh", "grid"],
     "single-process"),
    (["--delete", "a,b", "--index-dir", "x"], "integer"),
    (["--upsert", "-3", "--index-dir", "x"], ">= 0"),
    (["--route", "bounded"], "--index-dir"),
    (["--route", "nprobe"], "--index-dir"),
    (["--nprobe", "0", "--index-dir", "x"], ">= 1"),
    (["--nprobe", "-2", "--route", "nprobe", "--index-dir", "x"], ">= 1"),
    (["--centroids-per-bucket", "0", "--index-dir", "x"], ">= 1"),
    (["--route", "ivf", "--index-dir", "x"], "invalid choice"),
    (["--route", "nprobe", "--index-dir", "x", "--upsert", "2"],
     "routing table"),
    (["--flush-ms", "5"], "--serve-loop"),
    (["--max-batch", "16"], "--serve-loop"),
    (["--serve-loop", "--flush-ms", "-1"], ">= 0"),
    (["--serve-loop", "--max-batch", "0"], ">= 1"),
    (["--serve-loop", "--arch", "smoke"], "late-interaction"),
    # beyond tests/test_serve_cli.py
    (["--pool-threshold", "1.5"], "(0, 1]"),
    (["--residual-bits", "3"], "invalid choice"),
    (["--backend", "tpu"], "invalid choice"),
    (["--serve-loop", "--arch", "minitron-4b", "--device", "cpu"],
     "late-interaction"),
    (["--mesh", "cluster"], "invalid choice"),
    (["--on-group-loss", "retry"], "invalid choice"),
    (["--hosts", "2", "--kill-group", "1", "--mesh", "host"], "--mesh grid"),
]

ACCEPTS = [
    [],
    ["--mesh", "grid", "--replicas", "2", "--kill-group", "1"],
    ["--replicas", "1"],
    ["--index-dir", "/tmp/x", "--upsert", "8", "--delete", "3, 5 ,7",
     "--compact"],
    ["--index-dir", "x", "--delete", "4,"],
    ["--route", "nprobe", "--nprobe", "3", "--centroids-per-bucket", "8",
     "--index-dir", "/tmp/x"],
    ["--route", "bounded", "--index-dir", "x", "--mesh", "grid"],
    ["--serve-loop", "--flush-ms", "0.5", "--max-batch", "16"],
    ["--serve-loop"],
    ["--serve-loop", "--index-dir", "x", "--upsert", "4", "--compact"],
    ["--index-dir", "x", "--compact", "--mesh", "host"],
    # beyond tests/test_serve_cli.py
    ["--backend", "fused", "--compress", "residual", "--residual-bits", "2",
     "--pool-threshold", "0.9", "--n-first", "0", "--keep", "0.3"],
    ["--arch", "minitron-4b", "--tokens", "4", "--device", "cpu"],
    ["--mesh", "host", "--replicas", "2"],
    ["--mesh", "grid", "--hosts", "2", "--on-group-loss", "rebalance",
     "--kill-group", "0", "--n-first", "0"],
]


def _error_line(stderr):
    """argparse's last line, ``prog: error: message``, with the program
    and package names made the same."""
    line = stderr.strip().splitlines()[-1]
    for prog in ("repro_torch.launch.serve", "repro.launch.serve"):
        line = line.replace(prog, "PROG")
    return line.replace("repro_torch.", "repro.")


def _reference_argv(argv):
    """The argv without the port's ``--device`` flag."""
    out = list(argv)
    if "--device" in out:
        i = out.index("--device")
        del out[i:i + 2]
    return out


@pytest.mark.parametrize("argv,needle", REJECTS,
                         ids=lambda v: " ".join(v) if isinstance(v, list)
                         else None)
def test_rejects_as_the_reference(argv, needle, capsys):
    errors = []
    for parse, a in ((serve.parse_args, argv),
                     (j_serve.parse_args, _reference_argv(argv))):
        with pytest.raises(SystemExit) as exc:
            parse(a)
        assert exc.value.code == 2          # a usage error, not a crash
        errors.append(_error_line(capsys.readouterr().err))
    assert errors[0] == errors[1]
    assert needle in errors[0]


@pytest.mark.parametrize("argv", ACCEPTS, ids=lambda v: " ".join(v) or "[]")
def test_accepts_as_the_reference(argv):
    got = vars(serve.parse_args(argv))
    want = vars(j_serve.parse_args(_reference_argv(argv)))
    assert got.pop("device") == (argv[argv.index("--device") + 1]
                                 if "--device" in argv else None)
    assert got == want


def test_parser_has_the_reference_flags():
    """Every flag of the reference's parser, with its default, choices
    and type, plus ``--device``."""
    def flags(ap):
        return {a.dest: (tuple(a.option_strings), a.default,
                         None if a.choices is None else list(a.choices),
                         a.type, a.nargs, a.const)
                for a in ap._actions if a.dest != "help"}
    got, want = flags(serve.build_parser()), flags(j_serve.build_parser())
    assert got.pop("device") == (("--device",), None, None, None, None,
                                 None)
    assert got == want
    text = serve.build_parser().format_help()
    for opts, *_ in want.values():
        assert all(o in text for o in opts)


def test_serve_loop_leg(capsys):
    res = serve.main(["--serve-loop", "--flush-ms", "1", "--max-batch", "4",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] loop parity vs serial: True" in out
    assert res.loop["parity"] and res.loop["queries"] == 32
    assert res.loop["flushes"] >= 8         # max_batch 4: >= 32 / 4 flushes
    assert set(res.loop["batch_shapes"]) <= {(n, 8, 32) for n in (1, 2, 4)}
    assert len(res.loop["epoch_keys"]) in (1, 2)
    assert res.idx.shape == (32, 10) and "loop_s" in res.timings


def test_mutation_lifecycle_then_routed(tmp_path, capsys):
    d = str(tmp_path / "art")
    res = serve.main(["--index-dir", d, "--upsert", "8", "--delete", "1,2",
                      "--compact", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] upserted 8 docs" in out
    assert "tombstoned doc ids [1, 2]" in out
    assert "post-compact parity: True; orphans: 0" in out
    assert res.idx.shape == (32, 10)
    assert not np.isin(res.idx, [1, 2]).any()       # the tombstones
    res = serve.main(["--index-dir", d, "--route", "bounded",
                      "--serve-loop", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] loaded packed index from" in out
    assert "routed recall@10 vs exhaustive: 1.000" in out   # bounded: exact
    assert "[serve] loop parity vs serial: True" in out


def test_ckpt_dir_serves_the_trained_encoder(tmp_path, capsys):
    c = str(tmp_path / "ckpt")
    trained = train_lib.run("colbert", steps=1, batch=2, log_every=0,
                            ckpt_dir=c, device="cpu")
    res = serve.main(["--ckpt-dir", c, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored encoder parameters from step 1" in out
    restored = serve.restore_encoder(c, colbert_base.SMOKE, "cpu")
    want = dict(trained["state"]["params"].named_parameters())
    for name, p in restored.named_parameters():
        assert torch.equal(p, want[name]), name
    # not the seed-0 initialisation the run would draw without it
    fresh = serve.init_params(torch.Generator().manual_seed(0),
                              colbert_base.SMOKE, "cpu")
    assert any(not torch.equal(p, q) for p, q in zip(
        restored.parameters(), fresh.parameters()))
    ref = serve.serve_retrieval(colbert_base.SMOKE, model=restored,
                                device="cpu")
    np.testing.assert_array_equal(res.idx, ref.idx)
    np.testing.assert_array_equal(res.scores, ref.scores)
    # the line a script compares runs by
    assert (f"[serve] top-10 sha1: {serve.top_k_digest(ref.idx, ref.scores)}"
            in out)


def test_ckpt_dir_without_a_train_checkpoint_raises(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="empty"):
        serve.main(["--ckpt-dir", str(empty), "--device", "cpu"])
    # a checkpoint that is not a ColBERT train state restores nothing
    other = str(tmp_path / "other")
    checkpoint.save(other, 3, {"w": torch.ones(2)})
    with pytest.raises(FileNotFoundError, match="other"):
        serve.main(["--ckpt-dir", other, "--device", "cpu"])
    with pytest.raises(ValueError, match="not both"):
        serve.serve_retrieval(colbert_base.SMOKE, ckpt_dir=other,
                              model=object(), device="cpu")


def test_ckpt_dir_moot_under_a_loaded_artifact(tmp_path, capsys):
    c, d = str(tmp_path / "ckpt"), str(tmp_path / "art")
    train_lib.run("colbert", steps=1, batch=2, log_every=0, ckpt_dir=c,
                  device="cpu")
    serve.main(["--index-dir", d, "--device", "cpu"])
    capsys.readouterr()
    serve.main(["--index-dir", d, "--ckpt-dir", c, "--device", "cpu"])
    assert "WARNING: --ckpt-dir ignored" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["minitron-4b", "granite-moe-3b-a800m",
                                  "mixtral-8x7b"])
def test_lm_arch_decodes_its_smoke_config(arch, capsys):
    ids, timings = serve.main(["--arch", arch, "--tokens", "4",
                               "--device", "cpu"])
    assert ids.shape == (2, 4) and ids.dtype == torch.int32
    assert "[serve] decoded 4 tokens x 2 seqs" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["bert4rec", "dlrm-rm2", "gin-tu",
                                  "no-such-arch"])
def test_missing_archs_raise_naming_item_8(arch):
    # bert4rec and dlrm-rm2 are ported, but the serve CLI has no recsys
    # path (the reference's has none either): it names the functions
    want = ("no recsys path.*serve_bert4rec" if arch in ("bert4rec",
                                                         "dlrm-rm2")
            else "§ A item 8")
    with pytest.raises(NotImplementedError, match=want):
        serve.main(["--arch", arch, "--device", "cpu"])


def test_main_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--serve-loop"])
