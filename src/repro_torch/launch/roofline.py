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

Collectives are counted by the reference's conventions
(``repro/launch/roofline.py::parse_hlo_costs``: an all-gather moves its
whole output, an all-reduce twice its operand, a reduce-scatter, an
all-to-all and a collective-permute their operand; backward and
recomputation count again) and at the width of the reference's HLO,
which is compiled for the host: its float normalisation widens bf16 to
fp32 before every collective, so a float element counts 4 bytes (a bf16
cell on the card would move half).  Two parts, summed a device:

* the parameters (:func:`param_collectives`, from the cell's specs).  A
  training step all-gathers each sharded parameter once a model pass,
  and once more in the backward where the parameter sits in the layer
  stack (XLA re-gathers inside the scanned backward; the embedding and
  head stay gathered); its gradient is all-reduced once a sharded
  dimension a pass (and its shard again over batch axes it is not split
  on), reduce-scattered where the cell pins gradients (``rs_grads``,
  ``zero_tables``), and a replicated parameter under a sharded batch
  all-reduces its gradient.  A serving step (prefill, decode, encode,
  serve, retrieval) all-gathers each parameter over the mesh axes its
  batch uses (the FSDP axis; a tensor-parallel axis stays sharded),
  except at decode, where a product whose weight is FSDP-sharded on its
  output dimension (``wo``, ``w_down``) gathers its one-token
  activations instead.  A gather over two dimensions is two gathers,
  the last dimension first; the first one's output counts too.  A CTR
  table (``tables``, ``wide``) is
  never gathered: a lookup reads the rows a device holds, and the
  table's gradient is all-reduced over the positions that hold the
  same shard.
* the activations (:class:`Collectives`, at the models' constraint
  points, the reference's, through ``sharding.constrain``): a product
  that contracts a sharded ``heads`` or ``ffn`` axis (attention's output
  projection, the MLP's and the experts' down projections) all-reduces
  its output; a head axis that does not divide its mesh ways is padded
  and gathered (queries, keys and values, and the grouped queries once
  more where the KV heads do not divide either); a sequence sharded in
  training gathers keys and values for attention and reduce-scatters
  their gradients; the GNN's segment sum over sharded edges into
  replicated nodes all-reduces the nodes (again in the backward where
  the messages need a gradient); a lookup into a table sharded by rows
  or table-wise all-gathers the ids over the axes the table takes from
  the batch and all-reduces the looked-up rows (and gathers their
  gradient back); logits sharded over the vocabulary all-reduce their
  softmax partials; decode over a sharded cache length all-reduces
  P.V and the softmax's max and sum; a catalog parameter read as
  candidates is gathered whole off its FSDP axis; and a top-k under a
  sharded batch all-gathers its operand (XLA's TopK is not
  partitioned).

Under the ``a2a_lookup`` and ``a2a_zero`` variants the CTR tables are
read through ``models/recsys.py::alltoall_lookup``: the exchange is
counted under ``"all-to-all"`` a device (:func:`lookup_exchange_bytes`:
in the forward the request buckets and the feature buckets, shards x
cap int32 each, the reference's dtype, and the rows sent back, shards x
cap x D, in the backward the rows' gradients again; ``"collectives":
"state+activations+a2a"``).

Left out: XLA's involuntary reshards (collective-permutes and stray
all-to-alls where 24 or 8 heads meet a 16-way axis; 5.3 % of
minitron-4b's ``prefill_32k``) and the LM embeddings' lookups (1.1 %
there; ``ROADMAP.md`` § C).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.models import recsys
from repro_torch.sharding.specs import (counting, current_rules,
                                        logical_to_spec)

__all__ = ["COLLECTIVES", "HBM_BW", "LINK_BW", "PEAK_BF16_FLOPS",
           "PEAK_FP32_FLOPS", "Collectives", "Costs", "analyze",
           "argument_bytes_per_device", "collectives", "count_costs",
           "counted_by", "lookup_exchange_bytes", "model_bound_s",
           "param_collectives", "peak_for", "roofline_terms"]

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
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
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


def count_costs(fn, *args, mesh=None, **kwargs):
    """``fn(*args, **kwargs)`` under :class:`Costs`: (its output, the
    costs).  With ``mesh`` (the cell's), a :class:`Collectives` counter
    reads the step's constraint points too (``costs.collectives``).  If
    ``fn`` raises, the exception carries the costs so far as ``costs``
    (their ``failed_op`` the op that raised)."""
    costs = Costs()
    costs.collectives = Collectives(mesh) if mesh is not None else None
    try:
        with costs, counting(costs.collectives):
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


def _wire(t) -> int:
    """Bytes of ``t`` in the reference's HLO: a float element 4 (the
    host compile widens bf16 to fp32 before a collective), an integer
    its own width."""
    return t.numel() * (4 if t.is_floating_point() else t.element_size())


def _axes_of(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _spec_axes(spec) -> set:
    return {a for part in spec or () for a in _axes_of(part)}


def _prod(axes, shape: dict) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _row_table(path) -> bool:
    """A CTR lookup table (``tables``, ``wide``), never gathered."""
    return any(k in ("tables", "wide") for k in path)


class Collectives:
    """The activation collectives of one step, a device, by the
    reference's conventions (module docstring): ``constrain`` and
    ``topk`` are called by ``sharding.constrain`` / ``note_topk`` at the
    models' constraint points while :func:`sharding.counting` routes
    them here.  ``bytes`` by collective type; ``sites`` by (type, the
    logical axes of the constraint that counted it)."""

    def __init__(self, mesh):
        self.shape = dict(mesh.shape)
        self.bytes = dict.fromkeys(COLLECTIVES, 0.0)
        self.sites: dict[tuple, float] = {}
        self._last = None       # (logical axes, spec, shape) of the last
        self._edges = None      # a sharded GNN message's width
        self._nodes_grad = False
        self._queries = 0.0     # q's padded all-gather, for k's

    def _add(self, kind, nbytes, logical):
        if nbytes:
            self.bytes[kind] += nbytes
            key = (kind, tuple(logical))
            self.sites[key] = self.sites.get(key, 0.0) + nbytes

    def _local(self, x, spec) -> float:
        """``x``'s bytes a device under ``spec``."""
        return _wire(x) / _prod(_spec_axes(spec), self.shape)

    def constrain(self, x, logical, ids=None):
        rules = current_rules() or {}
        spec = logical_to_spec(tuple(logical), rules)
        if ids is not None:
            self._lookup(x, spec, ids, rules, logical)
        elif logical[-2:] in (("heads", None), ("kv_heads", None)):
            self._heads(x, spec, logical)
        elif logical == ("edges", "feat"):
            if _prod(_axes_of(spec[0]), self.shape) > 1:
                self._edges = x.shape[-1]
        elif logical == ("nodes", "hidden"):
            # the layer's input is the last layer's output: where that
            # needs a gradient, the backward's scatter reduces again
            if self._edges:
                b = 2.0 * x.shape[0] * self._edges * 4 / _prod(
                    _axes_of(spec[0]), self.shape)
                self._add("all-reduce", b * (2 if self._nodes_grad else 1),
                          logical)
            self._edges = None
            self._nodes_grad = x.requires_grad
        elif logical == ("batch", "seq", "heads") and self._last is not None:
            prev_logical, prev_spec, prev_shape = self._last
            ways = _prod(_axes_of(prev_spec[-2]), self.shape)
            if prev_logical[-2:] == ("kv_len", None) and ways > 1:
                # decode over a sharded cache length: P.V (every head)
                # and the softmax's max and sum a head reduce over it
                b = self._local(x, spec) * _prod(_axes_of(spec[-1]),
                                                 self.shape)
                self._add("all-reduce", 2.0 * b * (1 + 2 / prev_shape[-1]),
                          logical)
        elif logical[-1] == "embed" and self._last is not None:
            prev_logical, prev_spec, _ = self._last
            if prev_logical[-1] in ("heads", "ffn"):
                gone = set(_axes_of(prev_spec[-1])) - _spec_axes(spec)
                if _prod(gone, self.shape) > 1:
                    self._add("all-reduce", 2.0 * self._local(x, spec),
                              logical)
        elif logical == ("candidates", None) and isinstance(x, nn.Parameter):
            # a catalog parameter read as candidates leaves its FSDP
            # sharding: XLA gathers it whole first
            if _prod(_axes_of(rules.get("fsdp")), self.shape) > 1:
                self._add("all-gather", float(_wire(x)), logical)
        elif logical[-1] == "vocab":
            ways = _prod(_axes_of(spec[-1]), self.shape)
            if ways > 1 and x.requires_grad:
                # the softmax's max and sum over the sharded vocabulary
                part = self._local(x, spec) * ways / x.shape[-1]
                self._add("all-reduce", 2 * 2.0 * part, logical)
        self._last = (tuple(logical), spec, tuple(x.shape))

    def _heads(self, x, spec, logical):
        """q, then k, then v (B, S, heads, hd) at attention's
        constraints: a head axis that does not divide its ways is padded
        to a multiple of them and gathered; where the KV heads do not
        divide either, the grouped queries are gathered once more (at
        k's constraint, with q's padded bytes)."""
        shape = self.shape
        heads = x.shape[2]
        ways = _prod(_axes_of(spec[2]), shape)
        full = 0.0
        if ways > 1 and heads % ways:
            rest = _prod(_spec_axes(spec) - set(_axes_of(spec[2])), shape)
            padded = -(-heads // ways) * ways if heads > ways else heads
            full = _wire(x) / heads * padded / rest
        if logical[2] == "heads":
            self._queries = full
        elif full:
            full += self._queries
            self._queries = 0.0
        self._add("all-gather", full, logical)
        seq = _prod(_axes_of(spec[1]), shape)
        if logical[2] == "kv_heads" and seq > 1:
            gathered = self._local(x, spec) * seq
            self._add("all-gather", gathered, logical)
            if x.requires_grad:
                self._add("reduce-scatter", gathered, logical)

    def _lookup(self, table, spec, ids, rules, logical):
        """A lookup of ``table`` (F, V[, D]) at ``ids`` (B, F)."""
        shape = self.shape
        owned = _spec_axes(spec[:2])            # table-wise or by rows
        batch = set(_axes_of(logical_to_spec(("batch",), rules)[0]))
        kept = batch - _spec_axes(spec)         # the ids stay split here
        n_ids = ids.numel() / _prod(kept, shape)
        if batch - kept:
            self._add("all-gather", n_ids * ids.element_size(), logical)
        if _prod(owned, shape) > 1:
            D = table.shape[2] if table.dim() > 2 else 1
            d_ways = _prod(_axes_of(spec[2]) if table.dim() > 2 else (),
                           shape)
            rows = n_ids * D / d_ways * 4
            self._add("all-reduce", 2.0 * rows, logical)
            if (torch.is_grad_enabled() and table.requires_grad
                    and batch - kept):
                self._add("all-gather", rows, logical)

    def topk(self, x):
        batch = logical_to_spec(("batch",), current_rules() or {})[0]
        if _prod(_axes_of(batch), self.shape) > 1:
            self._add("all-gather", _wire(x), ("top_k",))


def _gathered(nbytes, spec, axes: set, shape: dict) -> float:
    """The all-gather bytes of a parameter of ``nbytes`` under ``spec``
    gathered over ``axes``: its output (split over the axes it keeps);
    gathered on two dimensions, XLA gathers the last one first, so the
    first gather's output counts too."""
    keep = _prod(_spec_axes(spec) - axes, shape)
    dims = [set(_axes_of(part)) & axes for part in spec or ()]
    dims = [d for d in dims if _prod(d, shape) > 1]
    out = nbytes / keep
    if len(dims) > 1:
        out += nbytes / keep / _prod(set().union(*dims[:-1]), shape)
    return out


def _decode_gathers_tokens(path, spec, fsdp: set) -> bool:
    """A decode step's product whose weight is FSDP-sharded on its
    output dimension (``wo``, ``w_down``): XLA gathers its one-token
    activations, not the weight."""
    return (len(spec) >= 2 and bool(_axes_of(spec[-1]))
            and set(_axes_of(spec[-1])) <= fsdp
            and path[-1] in ("wo", "w_down"))


def param_collectives(cell, tree=None) -> dict:
    """Per-device link bytes of a cell's parameters (module docstring),
    by collective type."""
    from repro_torch.launch.steps import leaves
    out = dict.fromkeys(COLLECTIVES, 0.0)
    shape = cell.mesh.shape
    n_pos = int(cell.mesh.devices.size)
    items = list(leaves(cell, tree))
    passes = cell.model_passes
    if cell.kind == "train":
        batch_sharded = any(_ways(s, shape) > 1 for p, _, s in items
                            if p[0] == 1)
        batch_axes = set().union(*(_spec_axes(s) for p, _, s in items
                                   if p[0] == 1))
        for p, t, s in items:
            if p[:2] != (0, "params"):
                continue
            b, ways = _wire(t), _ways(s, shape)
            if _row_table(p):
                if ways < n_pos:        # shard replicas reduce the gradient
                    out["all-reduce"] += 2 * b / ways
                elif cell.grads_pinned and not _a2a(cell):
                    out["reduce-scatter"] += b
                continue
            if ways > 1:
                out["all-gather"] += (_gathered(b, s, _spec_axes(s), shape)
                                      * passes
                                      * (2 if "layers" in p else 1))
                if cell.grads_pinned:
                    out["reduce-scatter"] += b * passes
                else:
                    dims = sum(_ways((part,), shape) > 1 for part in s)
                    out["all-reduce"] += 2 * b * dims * passes
                    if _prod(batch_axes - _spec_axes(s), shape) > 1:
                        # the shard, over the batch axes it is not split on
                        out["all-reduce"] += 2 * b / ways * passes
            elif batch_sharded:
                out["all-reduce"] += 2 * b
        return out
    if not isinstance(cell.args[0], nn.Module):     # no parameters
        return out
    batch = set(_axes_of(logical_to_spec(("batch",), cell.rules)[0]))
    fsdp = set(_axes_of(cell.rules.get("fsdp")))
    tokens = None
    if cell.kind == "decode":
        tokens = cell.args[2].numel()
    for p, t, s in items:
        if p[0] != 0 or _row_table(p):
            continue
        gathered = _spec_axes(s) & batch
        if _prod(gathered, shape) <= 1:
            continue
        local = _gathered(_wire(t), s, gathered, shape)
        if tokens is not None and _decode_gathers_tokens(p, s, fsdp):
            d_in = t.shape[-2] / _ways((s[-2],), shape)
            local = tokens * d_in * 4
        out["all-gather"] += local * passes
    return out


def collectives(cell, counts=None, tree=None) -> dict:
    """Per-device link bytes of the cell by collective type: its
    parameters', its activations' (``counts.collectives``, when the
    costs were counted with the cell's mesh) and its lookup exchange."""
    out = param_collectives(cell, tree)
    act = getattr(counts, "collectives", None)
    for k in COLLECTIVES:
        out[k] += act.bytes[k] if act is not None else 0.0
    out["all-to-all"] += lookup_exchange_bytes(cell)
    return out


def analyze(cell, counts, n_devices: int) -> dict:
    """The reference's record keys where they mean something here, from
    a cell and the :class:`Costs` of its step on the ``reference``
    path (counted with ``mesh=cell.mesh`` for the activations'
    collectives)."""
    from repro_torch.launch.steps import cell_tree
    tree = cell_tree(cell)
    per = {k: v / n_devices for k, v in counts.flops.items()}
    coll = collectives(cell, counts, tree)
    coll_total = sum(coll.values())
    terms = roofline_terms(per, counts.bytes / n_devices, coll_total)
    flops = sum(counts.flops.values())
    arg_b = argument_bytes_per_device(cell, tree)
    mf = cell.model_flops_per_step
    kinds = "state+activations" + ("+a2a" if lookup_exchange_bytes(cell)
                                   else "")
    return {
        "flops": flops,
        "flops_by_dtype": dict(counts.flops),
        "bytes": counts.bytes,
        "collective_bytes_per_device": coll_total,
        "collective_breakdown": coll,
        "collectives": kinds,
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

