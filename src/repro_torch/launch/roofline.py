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
  all-reduces its gradient.  Where training splits the sequence (the
  multi-pod mesh), the token lookup gathers the embedding table whole
  and reduces its gradient over the sequence's axes and then the
  batch's (a tied table's head gathers and reduces it once more), and
  the experts' gate and up weights keep their ffn split where the
  experts' ffn axis is.  A serving step (prefill, decode, encode,
  serve, retrieval) all-gathers each parameter over the mesh axes its
  batch uses (the FSDP axis; a tensor-parallel axis stays sharded),
  except at decode, where a dense product whose weight is FSDP-sharded
  on its output dimension (``wo``, ``w_down``) gathers its one-token
  activations instead, and a tied head with a replicated vocabulary
  keeps its shard (a permute of it, the logits reduced).  A gather over
  two dimensions is two gathers, the last dimension first; the first
  one's output counts too.  A CTR table (``tables``, ``wide``) is never
  gathered: a lookup reads the rows a device holds, and the table's
  gradient is all-reduced over the positions that hold the same shard.
* the activations (:class:`Collectives`, at the models' constraint
  points, the reference's, through ``sharding.constrain``, and at the
  top-ks, attentions and catalog lookups the models mark with
  ``note_topk``, ``note_attention`` and ``note_lookup``): a product
  that contracts a sharded ``heads`` or ``ffn`` axis (attention's output
  projection, the MLP's and the experts' down projections) all-reduces
  its output (in training, the experts' two up projections' input
  gradients too, and their weight gradients gather the ffn side); a
  head axis that does not divide its mesh ways is padded and gathered
  (queries, keys and values, and the grouped queries once more where
  the KV heads do not divide either; where only the KV heads fail to
  divide, the queries are gathered whole and P.V reduces over the
  split key positions); a sequence split in training runs the query
  chunks as XLA partitions the reference's scan
  (:meth:`Collectives.attention`) and gathers the sequence into the
  MoE blocks; the GNN's segment sum over sharded edges into replicated
  nodes all-reduces the nodes (again in the backward where the messages
  need a gradient); a lookup into a table sharded by rows or table-wise
  all-gathers the ids over the axes the table takes from the batch and
  all-reduces the looked-up rows (and gathers their gradient back);
  a catalog read at batch-split ids gathers its rows
  (:meth:`Collectives.lookup`); logits sharded over the vocabulary
  all-reduce their softmax partials; decode over a sharded cache length
  gathers the queries and the new token's keys and values over the
  heads' ways and all-reduces P.V and the softmax's max and sum; a
  batch-1 decode keeps every weight's FSDP shard, so its products reduce
  or gather their small outputs over the FSDP axis instead (on a mesh
  with a pod axis of weight replicas, XLA gathers the experts' gate and
  up weights there); a catalog parameter read as candidates moves its
  FSDP split to its rows by all-to-all where the ways match, else is
  gathered whole; and a top-k gathers an operand split on any axis
  (XLA's TopK is not partitioned).

Under the ``a2a_lookup`` and ``a2a_zero`` variants the CTR tables are
read through ``models/recsys.py::alltoall_lookup``: the exchange is
counted under ``"all-to-all"`` a device (:func:`lookup_exchange_bytes`:
in the forward the request buckets and the feature buckets, shards x
cap int32 each, the reference's dtype, and the rows sent back, shards x
cap x D, in the backward the rows' gradients again; ``"collectives":
"state+activations+a2a"``).

Every ``ok`` cell of both production meshes is within 25 % of the
reference's compiled HLO, in total and in each type that makes up 10 %
of it (``PERF.md`` § 6).  Left out: XLA's involuntary reshards
(collective-permutes and stray all-to-alls where 24 or 8 heads meet a
16-way axis; 5.3 % of minitron-4b's ``prefill_32k``) and the LM
embeddings' lookups outside a split sequence (1.1 % there;
``ROADMAP.md`` § C).
"""

from __future__ import annotations

import math

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
    reference's conventions (module docstring): ``constrain``,
    ``topk``, ``attention`` and ``lookup`` are called by
    ``sharding.constrain`` and ``note_topk`` / ``note_attention`` /
    ``note_lookup`` at the models' constraint points while
    :func:`sharding.counting` routes them here.  ``bytes`` by collective
    type; ``sites`` by (type, the logical axes of the constraint that
    counted it)."""

    def __init__(self, mesh):
        self.shape = dict(mesh.shape)
        self.bytes = dict.fromkeys(COLLECTIVES, 0.0)
        self.sites: dict[tuple, float] = {}
        self._last = None       # (logical axes, spec, shape) of the last
        self._edges = None      # a sharded GNN message's width
        self._nodes_grad = False
        self._queries = 0.0     # q's padded all-gather, for k's
        self._whole = 0.0       # q's bytes with every head, for k's

    def _add(self, kind, nbytes, logical):
        if nbytes:
            self.bytes[kind] += nbytes
            key = (kind, tuple(logical))
            self.sites[key] = self.sites.get(key, 0.0) + nbytes

    def _local(self, x, spec) -> float:
        """``x``'s bytes a device under ``spec``: each dimension split
        into ceil(size / ways) (XLA pads a dimension shorter than its
        ways, so a one-block MoE buffer stays whole on every device)."""
        n = _wire(x) / max(x.numel(), 1)
        for i, d in enumerate(x.shape):
            part = spec[i] if i < len(spec) else None
            n *= -(-d // _prod(_axes_of(part), self.shape))
        return float(n)

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
                # decode over a sharded cache length: the queries meet
                # the cache's whole KV-head axis, gathered; P.V (every
                # head) and the softmax's max and sum a head reduce over
                # the length
                local = self._local(x, spec)
                b = local * _prod(_axes_of(spec[-1]), self.shape)
                self._add("all-gather", b, logical)
                self._add("all-reduce", 2.0 * b * (1 + 2 / prev_shape[-1]),
                          logical)
                if self._fsdp_kept(x) > 1:
                    # the q, k and v products contract the FSDP-split
                    # input dimension: their outputs reduce over it
                    kv = prev_shape[1] * prev_shape[-1] / x.shape[-1]
                    self._add("all-reduce", 2.0 * local * (1 + 2 * kv),
                              logical)
        elif (logical == ("batch", "kv_heads", "kv_len", None)
              and spec[1] is None):
            # the new token's K (or V) comes from a product split over
            # the heads' ways; the cache's KV-head axis takes it whole
            if _prod(_axes_of(logical_to_spec(("heads",), rules)[0]),
                     self.shape) > 1:
                B, kv, _, hd = x.shape
                self._add("all-gather", -(-B // _prod(_axes_of(spec[0]),
                                                      self.shape))
                          * kv * hd * 4.0, logical)
        elif logical == ("batch", None, "embed") and self._seq_split():
            # tokens into MoE blocks: XLA gathers the sequence (again in
            # the backward)
            b = self._local(x, spec) * (2 if self._backward(x) else 1)
            self._add("all-gather", b, logical)
        elif logical[-1] == "embed" and self._last is not None:
            prev_logical, prev_spec, _ = self._last
            if prev_logical[-1] in ("heads", "ffn"):
                gone = set(_axes_of(prev_spec[-1])) - _spec_axes(spec)
                if _prod(gone, self.shape) > 1:
                    # in the backward, the input gradients of the two
                    # products that made the ffn axis contract it again
                    n = (3 if prev_logical[-1] == "ffn"
                         and self._backward(x) else 1)
                    b = self._local(x, spec)
                    fsdp = self._fsdp_kept(x)
                    if fsdp > 1:
                        # the weight keeps its FSDP split on the output:
                        # reduce that slice, then gather it
                        self._add("all-gather", b, logical)
                        b /= fsdp
                    self._add("all-reduce", 2.0 * b * n, logical)
        elif logical[-1] == "ffn" and logical[0] == "batch":
            ways = _prod(_axes_of(spec[-1]), self.shape)
            fsdp = self._fsdp_kept(x)
            if ways > 1 and fsdp > 1:
                used = (_spec_axes(spec) | set(_axes_of(rules.get("fsdp")))
                        | set(_axes_of(logical_to_spec(("batch",),
                                                       rules)[0])))
                if (logical[1] == "expert" and self._last is not None
                        and set(self.shape) - used):
                    # on a mesh with an axis of whole weight replicas
                    # (pod), XLA gathers the experts' gate and up
                    # weights' FSDP shards instead (their ffn split kept)
                    E, F, D = x.shape[1], x.shape[-1], self._last[2][-1]
                    self._add("all-gather", 2.0 * E * D * -(-F // ways) * 4,
                              logical)
                else:
                    # the gate and up products contract the FSDP-split
                    # input dimension: both outputs reduce over it
                    self._add("all-reduce", 2 * 2.0 * self._local(x, spec),
                              logical)
            if (logical == ("batch", "expert", None, "ffn") and ways > 1
                    and self._backward(x)):
                # the experts' weight gradients (FSDP on every axis) take
                # their ffn-side activation whole: one gather a weight
                self._add("all-gather", 3 * self._local(x, spec) * ways,
                          logical)
        elif logical == ("candidates", None) and isinstance(x, nn.Parameter):
            # a catalog parameter read as candidates leaves its FSDP
            # split on its columns: where its rows go to as many ways,
            # XLA moves the split by an all-to-all of its shard (then a
            # permute where the rows' mesh axes differ), else it gathers
            # the catalog whole
            fsdp = set(_axes_of(rules.get("fsdp")))
            ways = _prod(fsdp, self.shape)
            if ways > 1 and ways == _prod(_spec_axes(spec), self.shape):
                self._add("all-to-all", _wire(x) / ways, logical)
                if fsdp != _spec_axes(spec):
                    self._add("collective-permute", self._local(x, spec),
                              logical)
            elif ways > 1:
                self._add("all-gather", float(_wire(x)), logical)
        elif logical[-1] == "vocab":
            ways = _prod(_axes_of(spec[-1]), self.shape)
            if ways > 1 and x.requires_grad:
                # the softmax's max and sum over the sharded vocabulary
                part = self._local(x, spec) * ways / x.shape[-1]
                self._add("all-reduce", 2 * 2.0 * part, logical)
        self._last = (tuple(logical), spec, tuple(x.shape))

    def _seq_split(self) -> bool:
        """The last constraint split the sequence (``("batch", "seq",
        "embed")`` with its ``seq`` on more than one position)."""
        if self._last is None or self._last[0] != ("batch", "seq", "embed"):
            return False
        return _prod(_axes_of(self._last[1][1]), self.shape) > 1

    def _fsdp_kept(self, x) -> int:
        """The ways of a serving step's FSDP axes that its batch leaves
        free (the batch-1 decode): there XLA keeps each weight's FSDP
        shard and moves the activations instead of gathering it."""
        if x.requires_grad:
            return 1
        rules = current_rules() or {}
        batch = set(_axes_of(logical_to_spec(("batch",), rules)[0]))
        return _prod(set(_axes_of(rules.get("fsdp"))) - batch, self.shape)

    @staticmethod
    def _backward(x) -> bool:
        """``x`` will take a gradient and this is the step's first
        forward (not its recomputation inside the backward): the place
        to count the backward's collectives once."""
        return (x.requires_grad
                and torch._C._current_graph_task_id() == -1)

    def _heads(self, x, spec, logical):
        """q, then k, then v (B, S, heads, hd) at attention's
        constraints: a head axis that does not divide its ways is padded
        to a multiple of them and gathered; where the KV heads do not
        divide either, the grouped queries are gathered once more (at
        k's constraint, with q's padded bytes)."""
        shape = self.shape
        heads = x.shape[2]
        ways = _prod(_axes_of(spec[2]), shape)
        rest = _prod(_spec_axes(spec) - set(_axes_of(spec[2])), shape)
        full = 0.0
        if ways > 1 and heads % ways:
            padded = -(-heads // ways) * ways if heads > ways else heads
            full = _wire(x) / heads * padded / rest
        if logical[2] == "heads":
            self._queries = full
            self._whole = _wire(x) / rest if ways > 1 else 0.0
        elif full:
            if self._queries:
                full += self._queries
            elif self._whole:
                # queries whose heads divide their ways meet KV heads
                # that do not: XLA gathers the queries' group factor,
                # then their KV-head factor, and splits the keys'
                # positions instead, so P.V reduces the whole output
                full += self._whole * (1 + 1 / heads)
                self._add("all-reduce", 2.0 * self._whole, logical)
            self._queries = self._whole = 0.0
        self._add("all-gather", full, logical)

    def attention(self, q, k, chunk):
        """Attention over a sequence sharded ``W`` ways (training on the
        multi-pod mesh), counted as XLA partitions the reference's
        query-chunk scan.  The sequence's ways split into ``a`` on the
        chunk index and ``r`` on a chunk's rows; every chunk step
        gathers the stacked query chunks' index (once a layer pass, twice
        in the backward).  Where the query group ``g`` (heads a KV head)
        is at most ``r`` (or ``r`` is 1), the keys stay split ``W`` ways:
        a chunk gathers its query rows, reduces P.V over the rows' ways
        at full rows and over the index's ways at its own rows, and
        reduces the softmax's max and sum over all ``W``; the backward
        gathers the output gradient's and the probabilities' rows and
        reduces dQ as P.V.  Where ``g`` is larger, keys and values are
        gathered over the rows' ways once a layer pass and the query rows
        stay split.  Forward terms count at each call, the recomputation
        included; backward terms at the first call of a step that
        records gradients."""
        logical = ("batch", "seq", "heads", None)
        spec = logical_to_spec(logical, current_rules() or {})
        W = _prod(_axes_of(spec[1]), self.shape)
        if W <= 1:
            return
        B, S, H, hd = q.shape
        kv = k.shape[2]
        g = H // kv
        c = S if chunk is None else min(chunk, S)
        n = -(-S // c)
        a = math.gcd(W, n)
        r = W // a
        row = B / _prod(_axes_of(spec[0]), self.shape) * 4  # fp32, a row
        qc = row * c * H * hd                      # one query chunk
        bwd = self._backward(q)
        if a > 1:
            self._add("all-gather", row * n * c / r * H * hd * (3 if bwd
                                                                else 1),
                      logical)
        pv = 2 * qc / r if a > 1 else 0.0         # P.V over the index
        if r == 1 or g <= r:
            full = qc if r > 1 else 0.0
            soft = row * H * c
            # the backward gathers the probabilities' rows once more
            # where the group neither is 1 nor fills the rows' ways
            again = int(1 < g and g % r != 0)
            ag = n * full * (1 + (2 + again if bwd else 0))
            ar = n * ((2 * full + pv) * (2 if bwd else 1)
                      + 2 * 2 * soft + (2 * soft if bwd else 0))
            if bwd and r > 1 and g % r == 0:
                # dS's rows onto the group axis, and back
                self._add("all-to-all", n * 2 * soft * S / W, logical)
        else:
            kvg = row * S / a * kv * hd           # K (or V) over the rows
            soft = row * H * c / r
            ag = 2 * kvg * (2 if bwd else 1)
            ar = n * (pv * (2 if bwd else 1) + 2 * 2 * soft
                      + (2 * soft + 2 * 2 * kvg if bwd else 0))
        self._add("all-gather", ag, logical)
        self._add("all-reduce", ar, logical)

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

    def lookup(self, table, ids):
        """Rows of a catalog parameter (V, D), FSDP-split on D, read at
        batch-split ids (BERT4Rec's labels and serving targets), as XLA
        partitions the gather: the rows are read at the column shard and
        gathered over the batch's innermost axis; where the batch spans
        a further axis (the multi-pod mesh's ``pod``) they are then
        gathered whole, columns over the FSDP axis and rows over the
        rest, else they return to their batch shards by an all-to-all
        and a permute.  In training each such read all-reduces its own
        whole-table gradient over every device."""
        rules = current_rules() or {}
        shape = self.shape
        fsdp = set(_axes_of(rules.get("fsdp")))
        batch = _axes_of(logical_to_spec(("batch",), rules)[0])
        fw = _prod(fsdp, shape)
        if fw <= 1 or _prod(batch, shape) <= 1:
            return
        free = [a for a in batch if a not in fsdp]
        rest = _prod(free[:-1], shape)
        rows = ids.numel() * table.shape[1] * 4    # every column, fp32
        logical = ("lookup",)
        self._add("all-gather", rows / rest / fw, logical)
        if rest > 1:
            self._add("all-gather", rows / rest + rows, logical)
        else:
            local = rows / _prod(batch, shape)
            self._add("all-to-all", local, logical)
            self._add("collective-permute", local, logical)
        if torch.is_grad_enabled() and table.requires_grad:
            self._add("all-reduce", 2.0 * _wire(table), logical)

    def topk(self, x, logical):
        """A top-k over ``x``'s last axis: XLA's TopK is not partitioned,
        so an operand sharded on any axis is gathered whole."""
        spec = logical_to_spec(tuple(logical), current_rules() or {})
        if _prod(_spec_axes(spec), self.shape) > 1:
            self._add("all-gather", float(_wire(x)), ("top_k",))


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
            and path[-1] in ("wo", "w_down") and "moe" not in path)


def _head_keeps_shard(path, spec, tied: bool) -> bool:
    """The LM head at decode when its vocabulary dimension is replicated
    (the tied ``embed`` (vocab, d), FSDP on d)."""
    return tied and path[1:] == ("embed",) and spec[0] is None


def param_collectives(cell, tree=None) -> dict:
    """Per-device link bytes of a cell's parameters (module docstring),
    by collective type."""
    from repro_torch.launch.steps import leaves
    out = dict.fromkeys(COLLECTIVES, 0.0)
    shape = cell.mesh.shape
    n_pos = int(cell.mesh.devices.size)
    items = list(leaves(cell, tree))
    passes = cell.model_passes
    tied = not any("lm_head" in p for p, _, _ in items)
    if cell.kind == "train":
        batch_sharded = any(_ways(s, shape) > 1 for p, _, s in items
                            if p[0] == 1)
        batch_axes = set().union(*(_spec_axes(s) for p, _, s in items
                                   if p[0] == 1))
        seq = _prod(_axes_of(cell.rules.get("seq")), shape) > 1
        ffn_ways = _prod(_axes_of(logical_to_spec(
            ("batch", "expert", None, "ffn"), cell.rules)[3]), shape)
        for p, t, s in items:
            if p[:2] != (0, "params"):
                continue
            b, ways = _wire(t), _ways(s, shape)
            if seq and p[2:] == ("embed",):
                # the token lookup under a sharded sequence gathers the
                # table and reduces its gradient over the sequence's axes,
                # then the batch's; a tied table's head gathers and
                # reduces once more
                out["all-gather"] += b * (2 if tied else 1)
                out["all-reduce"] += 2 * b * (3 if tied else 2)
                continue
            if _row_table(p):
                if ways < n_pos:        # shard replicas reduce the gradient
                    out["all-reduce"] += 2 * b / ways
                elif cell.grads_pinned and not _a2a(cell):
                    out["reduce-scatter"] += b
                continue
            if ways > 1:
                g = _gathered(b, s, _spec_axes(s), shape)
                if p[-2:] in (("moe", "w_gate"), ("moe", "w_up")):
                    # their ffn dimension stays split where the experts'
                    # ffn axis is
                    g /= ffn_ways
                out["all-gather"] += g * passes * (2 if "layers" in p else 1)
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
        if tokens is not None and _head_keeps_shard(p, s, tied):
            # a head whose vocabulary is replicated keeps its FSDP
            # shard: the shard moves to the tokens and the logits
            # reduce over the FSDP axis
            vocab = t.shape[0]
            out["collective-permute"] += _wire(t) / _ways(s, shape)
            out["all-reduce"] += 2.0 * tokens / _prod(batch, shape) \
                * vocab * 4
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

