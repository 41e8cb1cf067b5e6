"""Roofline terms of a cell, counted on the ``meta`` device.

Counterpart of ``repro.launch.roofline``.  Per (arch x shape x mesh)
cell:

  compute term    = FLOPs of each operand dtype / that dtype's peak
  memory term     = bytes / HBM rate
  collective term = per-device link bytes / NVLink rate

each over the mesh's devices (the counted program is the whole step; a
device takes its share).  Hardware model, one NVIDIA H100 SXM (its
published peak rates): 989 TFLOP/s for bf16 and fp16 products
on the tensor cores, 67 TFLOP/s fp32, 3.35 TB/s HBM3, 450 GB/s of
NVLink each way.

The reference parses the compiled HLO; the port has none.  In its place
:func:`count_costs` runs the step under a ``TorchDispatchMode`` that
counts every aten op the step dispatches (backward and recomputation
included):

* FLOPs from ``torch.utils.flop_counter``'s formulas (the products:
  ``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, SDPA), split by
  the product's operand dtype;
* bytes by the reference's op-boundary rule: operands plus output;
  twice the output for the gathers (``index_select``, ``gather``,
  ``embedding``, advanced indexing, the copying slices); twice the
  update for the scatters (``index_put_``, ``scatter*``, ``index_add_``,
  ``index_copy_``, the slice scatters); nothing for views (an output
  that aliases an input: ``aten.slice`` is one in eager PyTorch) and
  for ``empty``.  In eager PyTorch every aten op reads its operands from
  HBM and writes its output there, so this is the eager program's
  traffic;
* the 8 costliest ops by bytes and by FLOPs (``top_ops``, the
  counterpart of ``tools/hlo_top_offenders.py``).

The counts are of the plain path (``counted_on: "reference"``): the
port's kernels are ``ctypes`` launches that no dispatch mode sees, and
on ``meta`` each kernel wrapper takes its plain version.  The plain
attention and the dense pruning path do more work than B7 and B2, so
the counted terms overstate those cells.

Data-dependent ops on ``meta`` take the upper bound that their shapes
fix (``counted_by`` in the record; "shapes" where no op needed one):
every edge kept and every id distinct.  :class:`Costs` answers a
boolean index (``aten.index``, ``aten.nonzero``) as if every element
were true and ``aten.unique_consecutive`` as if every value were
distinct, so ``take_rows``' backward (the CTR, BERT4Rec and MoE train
steps) sums one segment a row, as it does on all-distinct ids; and the
GNN gather plan's walk (``core/segment.py::_walk``) reports its bounds
instead of running: every edge gathered, at most ``min(E, segments +
ceil(E/64))`` pieces, and as many levels as a segment of all E edges
needs, each level's runs at most ``segments + ceil(runs/64)``, the last
one a run a segment.  On real arguments the counts are the data's own.

Collectives are counted from the cell's specs on the train state, by
the reference's conventions (an all-gather moves its full output, an
all-reduce twice its operand, a reduce-scatter and an all-to-all their
operand): a parameter sharded over k > 1 positions is all-gathered in
the forward and once more under remat, and its gradient is
reduce-scattered where the cell pins gradients to the parameters'
sharding (``rs_grads``, ``zero_tables``, ``a2a_zero``) and all-reduced
(XLA's all-reduce then slice) where it does not; a replicated parameter
under a sharded batch has its gradient all-reduced.

Under the ``a2a_lookup`` and ``a2a_zero`` variants the CTR tables are
read through ``models/recsys.py::alltoall_lookup``: a table is not
all-gathered (the lookup reads owned rows only), its gradient is its
owners' alone, all-reduced over the positions that hold the same shard
(2 x the shard's bytes; none under ``a2a_zero``, where every position
owns its own rows), and the exchange is counted under ``"all-to-all"``
a device: in the forward the request buckets and the feature buckets
(shards x cap int32 each, the reference's dtype) and the rows sent
back (shards x cap x D), in the backward the rows' gradients (the same
again; ``"collectives": "state+a2a"``).  Activation collectives of
tensor-parallel specs are not counted (``"collectives": "state"``).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.models import recsys

__all__ = ["HBM_BW", "LINK_BW", "PEAK_BF16_FLOPS", "PEAK_FP32_FLOPS",
           "Costs", "analyze", "argument_bytes_per_device", "count_costs",
           "counted_by", "lookup_exchange_bytes", "model_bound_s", "peak_for",
           "roofline_terms", "state_collectives"]

PEAK_BF16_FLOPS = 989e12     # bf16 / fp16 products on the tensor cores
PEAK_FP32_FLOPS = 67e12      # fp32
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s, NVLink each way

_HALF = (torch.bfloat16, torch.float16)
_GATHERS = {"index_select", "gather", "embedding", "index", "take",
            "take_along_dim", "slice_copy", "narrow_copy", "select_copy"}
# op name -> position of the update operand
_SCATTERS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
             "scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
             "index_add": 3, "index_add_": 3, "index_copy": 3,
             "index_copy_": 3, "slice_scatter": 1, "select_scatter": 1,
             "masked_scatter": 2, "masked_scatter_": 2}
_FREE = {"empty", "empty_like", "empty_strided", "_unsafe_view", "detach",
         "alias", "lift_fresh", "_local_scalar_dense", "set_"}


def peak_for(dtype) -> float:
    """The peak FLOP rate of products of ``dtype`` operands."""
    return PEAK_BF16_FLOPS if dtype in _HALF else PEAK_FP32_FLOPS


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _meta_long(*shape):
    return torch.empty(shape, dtype=torch.long, device="meta")


def _index_bound(x, indices, *rest):
    """``x[indices]`` with every boolean index all true: k index tensors
    of its numel for a k-dimensional mask (what ``nonzero`` gives)."""
    full = []
    for i in indices:
        if i is not None and i.dtype in (torch.bool, torch.uint8):
            full += [_meta_long(i.numel())] * i.dim()
        else:
            full.append(i)
    return (x, full, *rest)


def _unique_consecutive_bound(x, return_inverse=False, return_counts=False,
                              dim=None):
    """Every value distinct: (values, inverse, counts) as the CPU gives
    them for such an input (an output not asked for is empty)."""
    n = x.numel() if dim is None else x.shape[dim]
    values = torch.empty((n,) if dim is None else x.shape, dtype=x.dtype,
                         device="meta")
    inverse = _meta_long(*(x.shape if dim is None else (n,))) \
        if return_inverse else _meta_long(0)
    return values, inverse, _meta_long(n) if return_counts else _meta_long(0)


def _on_meta(args) -> bool:
    return any(t.is_meta for t in _tensors(args))


class Costs(TorchDispatchMode):
    """FLOPs (by operand dtype class, ``"bf16"`` or ``"fp32"``), bytes
    and per-op tallies of the aten ops dispatched while active; the op
    that raised, if one did (``failed_op``); the data-dependent ops that
    ``meta`` tensors took at their upper bound (``bounded``, by name:
    calls; module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = {"bf16": 0.0, "fp32": 0.0}
        self.bytes = 0.0
        self.ops: dict[str, list] = {}     # name -> [calls, flops, bytes]
        self.failed_op = None
        self.bounded: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        try:
            if _on_meta(args) and packet in (torch.ops.aten.index,
                                             torch.ops.aten.nonzero,
                                             torch.ops.aten.unique_consecutive):
                out, args = self._bound(func, args, kwargs)
            else:
                out = func(*args, **kwargs)
        except Exception:
            if self.failed_op is None:
                self.failed_op = str(func.overloadpacket)
            raise
        self._count(func, args, kwargs, out)
        return out

    def _bound(self, func, args, kwargs):
        """(the op's output at the upper bound its shapes fix, the
        arguments it is counted on) for a data-dependent op on meta."""
        packet = func.overloadpacket
        if packet is torch.ops.aten.index:
            if not any(i is not None and i.dtype in (torch.bool, torch.uint8)
                       for i in args[1]):
                return func(*args, **kwargs), args
            args = _index_bound(*args)
            out = func(*args, **kwargs)
        elif packet is torch.ops.aten.nonzero:
            out = _meta_long(args[0].numel(), args[0].dim())
        else:
            out = _unique_consecutive_bound(*args, **kwargs)
        name = str(packet)
        self.bounded[name] = self.bounded.get(name, 0) + 1
        return out, args

    def _count(self, func, args, kwargs, out):
        packet = func.overloadpacket
        name = packet.__name__
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            dt = next((t.dtype for t in _tensors(args)
                       if t.is_floating_point()), torch.float32)
            self.flops["bf16" if dt in _HALF else "fp32"] += flops
        if name in _FREE:           # bookkeeping, not in the tallies
            return
        if _is_view(func):
            nb = 0
        elif name in _GATHERS:
            nb = 2 * sum(_nbytes(t) for t in _tensors(out))
        elif name in _SCATTERS:
            i = _SCATTERS[name]
            upd = args[i] if len(args) > i else None
            if not isinstance(upd, torch.Tensor):
                upd = next((t for t in _tensors(out)), None)
            nb = 2 * _nbytes(upd)
        else:
            nb = (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                  + sum(_nbytes(t) for t in _tensors(out)))
        self.bytes += nb
        rec = self.ops.setdefault(str(packet), [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nb

    def top_ops(self, n: int = 8) -> dict:
        """The ``n`` costliest ops by bytes and by FLOPs."""
        rows = [{"op": k, "calls": v[0], "flops": v[1], "bytes": v[2]}
                for k, v in self.ops.items()]
        return {"by_bytes": sorted(rows, key=lambda r: -r["bytes"])[:n],
                "by_flops": [r for r in sorted(rows, key=lambda r: -r["flops"])
                             if r["flops"] > 0][:n]}


def count_costs(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under :class:`Costs`: (its output, the
    costs).  If ``fn`` raises, the exception carries the costs so far
    as ``costs`` (their ``failed_op`` the op that raised)."""
    costs = Costs()
    try:
        with costs:
            out = fn(*args, **kwargs)
    except Exception as e:
        e.costs = costs
        raise
    return out, costs


def roofline_terms(flops, bytes_accessed: float, coll_bytes: float) -> dict:
    """The three terms and the bound.  ``flops``: a dict by operand
    dtype class (``"bf16"``, ``"fp32"``), each part over its own peak,
    or one number of bf16 products (the reference's single peak)."""
    if not isinstance(flops, dict):
        flops = {"bf16": flops}
    compute_s = (flops.get("bf16", 0.0) / PEAK_BF16_FLOPS
                 + flops.get("fp32", 0.0) / PEAK_FP32_FLOPS)
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, collective_s)
    terms["dominant"] = dom
    terms["step_time_bound_s"] = bound
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    return terms


def _ways(spec, axes: dict) -> int:
    n = 1
    for part in spec or ():
        if part is None:
            continue
        for ax in ((part,) if isinstance(part, str) else part):
            n *= axes[ax]
    return n


def argument_bytes_per_device(cell, tree=None) -> float:
    """Sum over the cell's argument leaves of bytes / the positions
    their spec shards them over (stands in for the reference's
    ``memory_analysis``)."""
    from repro_torch.launch.steps import leaves
    axes = cell.mesh.shape
    return float(sum(_nbytes(t) / _ways(s, axes)
                     for _, t, s in leaves(cell, tree)))


def _a2a(cell) -> bool:
    return cell.rules.get("__lookup__") == "a2a"


def lookup_exchange_bytes(cell) -> float:
    """Per-device bytes of the all-to-alls of a CTR cell's
    ``alltoall_lookup`` (module docstring); 0 where the cell runs none
    (no a2a variant, or ``retrieval_cand``, whose user tower does not
    exchange)."""
    if not _a2a(cell) or cell.kind not in ("train", "serve"):
        return 0.0
    model = cell.args[0]["params"] if cell.kind == "train" else cell.args[0]
    B, n_feat = cell.args[1]["sparse_ids"].shape
    tables = model.tables
    plan = recsys.a2a_plan(cell.rules["__mesh__"], cell.rules, B, n_feat,
                           tables.shape[0] // n_feat)
    slots = plan.n_shards * plan.cap
    rows = slots * tables.shape[1] * tables.element_size()
    return 2 * slots * 4 + rows * (2 if cell.kind == "train" else 1)


def state_collectives(cell, tree=None) -> dict:
    """Per-device link bytes of a cell's train state and lookup exchange
    (module docstring): {"all-gather", "all-reduce", "reduce-scatter",
    "all-to-all"}; zeros for a cell that takes no train state and
    exchanges nothing."""
    from repro_torch.launch.steps import leaves
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": lookup_exchange_bytes(cell)}
    if cell.kind != "train":
        return out
    axes = cell.mesh.shape
    n_pos = int(cell.mesh.devices.size)
    items = list(leaves(cell, tree))
    batch_sharded = any(_ways(s, axes) > 1 for p, _, s in items
                        if p[0] == 1)
    for p, t, s in items:
        if p[:2] != (0, "params"):
            continue
        b = _nbytes(t)
        if _a2a(cell) and p[2] == "tables":
            ways = _ways(s, axes)
            if ways < n_pos:        # shard replicas reduce their gradient
                out["all-reduce"] += 2 * b / ways
            continue
        if _ways(s, axes) > 1:
            out["all-gather"] += b * (2 if cell.remat else 1)
            if cell.grads_pinned:
                out["reduce-scatter"] += b
            else:
                out["all-reduce"] += 2 * b
        elif batch_sharded:
            out["all-reduce"] += 2 * b
    return out


def analyze(cell, counts, n_devices: int) -> dict:
    """The reference's record keys where they mean something here, from
    a cell and the :class:`Costs` of its step on the ``reference``
    path."""
    from repro_torch.launch.steps import cell_tree
    tree = cell_tree(cell)
    per = {k: v / n_devices for k, v in counts.flops.items()}
    coll = state_collectives(cell, tree)
    coll_total = sum(coll.values())
    terms = roofline_terms(per, counts.bytes / n_devices, coll_total)
    flops = sum(counts.flops.values())
    arg_b = argument_bytes_per_device(cell, tree)
    mf = cell.model_flops_per_step
    return {
        "flops": flops,
        "flops_by_dtype": dict(counts.flops),
        "bytes": counts.bytes,
        "collective_bytes_per_device": coll_total,
        "collective_breakdown": coll,
        "collectives": "state+a2a" if coll["all-to-all"] else "state",
        **terms,
        "model_flops": mf,
        "useful_compute_fraction": mf / flops if flops > 0 else 0.0,
        "argument_bytes_per_device": arg_b,
        "model_bound_s": model_bound_s(cell, n_devices, arg_b),
        "compute_dtype": str(cell.compute_dtype).replace("torch.", ""),
        "counted_on": "reference",
        "counted_by": counted_by(counts),
        "top_ops": counts.top_ops(),
    }


def counted_by(counts) -> str:
    """The record's counting rule: "shapes", or the upper-bound rule
    with the ops it answered (module docstring)."""
    if not counts.bounded:
        return "shapes"
    return ("upper bound on meta (every edge kept, every id distinct): "
            + ", ".join(f"{k} x{v}" for k, v in sorted(counts.bounded.items())))


def model_bound_s(cell, n_devices: int = 1, arg_bytes=None) -> float:
    """``max(model FLOPs / (devices x the compute dtype's peak),
    argument bytes a device / HBM rate)``: the least time of the step's
    useful work and one read of its arguments."""
    if arg_bytes is None:
        arg_bytes = argument_bytes_per_device(cell)
    return max(cell.model_flops_per_step
               / (n_devices * peak_for(cell.compute_dtype)),
               arg_bytes / HBM_BW)

