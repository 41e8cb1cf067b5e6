"""Kernel micro-benchmarks: each CUDA kernel against its plain PyTorch
version at the reference's shapes.

Counterpart of ``benchmarks/bench_kernels.py``: B1 (``maxsim_top2``) at
the Voronoi estimator's shape (2,048 samples x 128 tokens, dim 128), B4
(``colbert_maxsim_op``, one query of 8 tokens against 64 docs x 32), B3
(``colbert_maxsim_multi_op``, 8 such queries), B8 (``embedding_bag_op``,
V 5,000, D 64, 256 bags x 4 ids) and B7 (``flash_attention_op``, 4 heads,
S 256, d 64, causal).  Each row prints the kernel's us a call, the plain
version's (``ref_us``) and the HBM bytes the fusion keeps out of device
memory (the score matrix or gathered rows the plain version writes);
then ``CLAIM_fused_matches_oracle``: B1's ids equal to the plain
version's and its scores within 1e-4.  Inputs are N(0, 1) draws from a
generator seeded with 0 (one seed an operand) on the device.  On the CPU
a wrapper runs its plain version, so the kernel column is the plain
version there, and each row says so.
"""

from __future__ import annotations

import torch

from repro_torch.core.backend import resolve_device
from repro_torch.kernels.colbert_maxsim.ops import (colbert_maxsim_multi_op,
                                                    colbert_maxsim_op)
from repro_torch.kernels.colbert_maxsim.ref import (colbert_maxsim_multi_ref,
                                                    colbert_maxsim_ref)
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.maxsim_top2.ops import maxsim_top2_op
from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_ref
from repro_torch.paper import common


def _randn(seed, *shape, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)


def run(device=None):
    """{row: (kernel s, plain s, hbm_bytes_avoided)} and the B1 oracle
    check ``(holds, max score error, ids equal)``."""
    dev = resolve_device(device)
    rows = {}

    def bench(name, kernel, plain, avoided):
        t_k, _ = common.timeit(kernel, repeat=3, device=dev)
        t_r, _ = common.timeit(plain, repeat=3, device=dev)
        rows[name] = (t_k, t_r, avoided)

    # B1 at the estimator's shape
    N, m, dim = 2048, 128, 128
    S = _randn(0, N, dim, device=dev)
    D = _randn(1, m, dim, device=dev)
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    bench("maxsim_top2_fused", lambda: maxsim_top2_op(S, D, alive),
          lambda: maxsim_top2_ref(S, D, alive), N * m * 4)
    # B4 at the rerank shape, B3 at a query-batch serving shape
    nd, md, l, nq = 64, 32, 8, 8
    q = _randn(0, l, dim, device=dev)
    docs = _randn(2, nd, md, dim, device=dev)
    msk = torch.ones((nd, md), dtype=torch.bool, device=dev)
    bench("colbert_maxsim_fused", lambda: colbert_maxsim_op(q, docs, msk),
          lambda: colbert_maxsim_ref(q, docs, msk), nd * md * l * 4)
    qb = _randn(6, nq, l, dim, device=dev)
    bench("colbert_maxsim_multi_fused",
          lambda: colbert_maxsim_multi_op(qb, docs, msk),
          lambda: colbert_maxsim_multi_ref(qb, docs, msk),
          nq * nd * md * l * 4)
    # B8 at the recsys lookup shape
    V, Dd, nb, nnz = 5000, 64, 256, 4
    table = _randn(0, V, Dd, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, V, (nb, nnz), generator=g, device=dev,
                        dtype=torch.int32)
    bench("embedding_bag_fused", lambda: embedding_bag_op(table, ids),
          lambda: embedding_bag_ref(table, ids), nb * nnz * Dd * 4)
    # B7 at a prefill tile
    H, Sf, dd = 4, 256, 64
    qf, kf, vf = (_randn(s, H, Sf, dd, device=dev) for s in (0, 4, 5))
    bench("flash_attention_fwd",
          lambda: flash_attention_op(qf, kf, vf, causal=True),
          lambda: flash_attention_ref(qf, kf, vf, causal=True),
          H * Sf * Sf * 4)

    got, want = maxsim_top2_op(S, D, alive), maxsim_top2_ref(S, D, alive)
    err = max((got[i] - want[i]).abs().max().item() for i in (0, 1))
    ids_ok = bool(torch.equal(got[2], want[2])
                  and torch.equal(got[3], want[3]))
    return rows, (err <= 1e-4 and ids_ok, err, ids_ok), dev


def report(out):
    rows, (ok, err, ids_ok), dev = out
    where = (f"device={dev.type}" if dev.type == "cuda" else
             "device=cpu;kernel column is the plain version (no card)")
    for name, (t_k, t_r, avoided) in rows.items():
        common.csv_line(f"kernels/{name}", t_k * 1e6,
                        f"ref_us={t_r * 1e6:.1f};hbm_bytes_avoided="
                        f"{avoided};{where}")
    common.csv_line("kernels/CLAIM_fused_matches_oracle", 0.0,
                    f"holds={ok};max_score_err={err:.3e};ids_equal={ids_ok}"
                    f";{where}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    report(run(device=device))


if __name__ == "__main__":
    main()
