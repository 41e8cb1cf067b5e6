"""An LM train cell's step placed over its mesh by its specs, from one
controller.

Counterpart of what the reference gets from ``jax.jit(step,
in_shardings=...)``: its sharded-step test (``tests/test_sharded_exec.py``)
and the placed cells its dry run compiles.  One process drives every
position of a ``launch.mesh.Mesh``; each position's work runs on that
position's device, and a mesh may repeat a device (the tests' CPU
positions, ``chip_smoke.py``'s positions of one card).

* :func:`place` cuts each tensor of a tree by its spec, the reference's
  ``PartitionSpec`` as a tuple (``launch.steps``).  A dimension whose
  entry names mesh axes is cut into as many equal blocks as those axes
  have positions; a position takes the block of its index on those axes
  in row-major order, as ``NamedSharding(mesh, P(("data", "model"),
  None))`` lays them out, and a copy where the spec replicates.
  Positions on one device that hold the same block share one tensor.  A
  spec naming an axis the mesh lacks, or cutting a dimension its axes
  do not divide, raises ``ValueError``; nothing is padded.
  :func:`gather` puts the blocks back together on one device.
* :func:`place_state` and :func:`gather_state` do the same for an LM
  train state.  The specs are those of the reference's state tree
  (``train_step.state_tree``: layers stacked, matrices (in, out)).
  Each is mapped onto the port's parameter through ``models.convert``'s
  layout: the stacked layer axis dropped (a spec that splits it
  raises), a transposed matrix's spec reversed.  A gathered state is an
  ordinary train state, which ``train/checkpoint.py`` writes through
  ``train_step.state_tree``.
* :func:`placed_step` is an LM train cell's step over placed states and
  batches.  For each distinct batch piece, in position order, it
  gathers the parameters onto that position's device and takes
  ``train_step.lm_loss_fn`` and its gradients through
  ``torch.func.functional_call`` (no module state changes).  The
  gradients are summed in position order into fp32 zeros and divided by
  the number of pieces, as ``lm_train_step``'s accumulation does; the
  clip's norm is ``optimizer.global_norm`` of the whole reduced
  gradients, which are then cut by each leaf's spec, and every position
  runs AdamW on its own pieces (a shared piece once).  With contiguous
  rows a position, a dense step is bit-equal to ``lm_train_step(...,
  accum=pieces)`` on one device.

MoE layers couple the positions twice, and the step keeps the
reference's global semantics at both (``models.moe.coupled``):

* the load-balance loss ``E · Σ me·ce`` takes ``ce`` from the expert
  counts of every position: a routing pass without gradients sums each
  layer's counts over the pieces before the first backward (``me`` and
  the router z-loss are means over tokens, and split linearly);
* a position's dispatch blocks must be the global blocks cut by rows;
  where they are not (``n_blocks`` takes one block of all T tokens when
  ``BLOCK_TOKENS`` does not divide T), the step raises ``ValueError``.

Expert parallel (rules whose ``"expert"`` names mesh axes, the
``ep_moe`` variant): each expert leaf is placed over those axes alone
(:func:`placed_specs`), so the positions of one ``data`` row own E / n
experts each and their pieces never leave their devices.  A position's
dispatch buffer is cut into its owners' (source, owner) pieces, each
owner computes its experts' SwiGLU on the piece sent to it, and the
outputs come back in the fixed expert order of ``models.moe``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.launch.mesh import Mesh
from repro_torch.models import convert
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.specs import logical_to_spec
from repro_torch.train import optimizer, train_step

__all__ = ["Placed", "gather", "gather_state", "place", "place_state",
           "placed_specs", "placed_step"]

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass
class Placed:
    """A tensor of ``shape`` cut over ``mesh`` by ``spec`` (one tuple of
    mesh axes a dimension, ``()`` where it is whole): ``pieces[i]`` is
    position i's block (row-major over ``mesh.devices``) on that
    position's device, ``blocks[i]`` its block index a dimension."""
    shape: tuple
    spec: tuple
    mesh: Mesh
    pieces: list
    blocks: list

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype


def _positions(mesh: Mesh) -> list:
    """(coordinates {axis: index}, device) of every position, row-major."""
    shape = mesh.devices.shape
    return [({a: int(c) for a, c in zip(mesh.axis_names,
                                         np.unravel_index(i, shape))}, dev)
            for i, dev in enumerate(mesh.devices.reshape(-1))]


def _count(axes, mesh: Mesh) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _axes(spec, shape, mesh: Mesh, name: str) -> tuple:
    """``spec`` as one tuple of mesh axes a dimension (missing trailing
    entries replicate), checked against ``mesh`` and ``shape``."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"{name} of shape {tuple(shape)}: spec {spec} "
                         "has more entries than dimensions")
    out = []
    for size, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        axes = (() if entry is None else (entry,) if isinstance(entry, str)
                else tuple(entry))
        missing = [a for a in axes if a not in mesh.axis_names]
        if missing:
            raise ValueError(f"{name} of shape {tuple(shape)}: spec {spec} "
                             f"names {missing}, which the mesh "
                             f"{mesh.shape} lacks")
        if size % _count(axes, mesh):
            raise ValueError(f"{name} of shape {tuple(shape)}: spec {spec} "
                             f"cuts a dimension of {size} into "
                             f"{_count(axes, mesh)} pieces on the mesh "
                             f"{mesh.shape}")
        out.append(axes)
    return tuple(out)


def _block(axes: tuple, coords: dict, mesh: Mesh) -> tuple:
    """A position's block index on every dimension: its row-major index
    on the dimension's axes."""
    out = []
    for dim_axes in axes:
        b = 0
        for a in dim_axes:
            b = b * mesh.shape[a] + coords[a]
        out.append(b)
    return tuple(out)


def _slices(shape, axes: tuple, mesh: Mesh, block: tuple) -> tuple:
    out = []
    for size, dim_axes, b in zip(shape, axes, block):
        w = size // _count(dim_axes, mesh)
        out.append(slice(b * w, (b + 1) * w))
    return tuple(out)


def _cut(x: torch.Tensor, axes: tuple, mesh: Mesh, copy: bool):
    """(pieces, blocks) of ``x`` over ``mesh``: a fresh tensor per
    (device, block) with ``copy``, else views where the device is
    ``x``'s and the block contiguous."""
    shared, pieces, blocks = {}, [], []
    for coords, dev in _positions(mesh):
        b = _block(axes, coords, mesh)
        if (b, dev) not in shared:
            shared[b, dev] = x[_slices(x.shape, axes, mesh, b)].to(
                dev, copy=copy, memory_format=torch.contiguous_format)
        pieces.append(shared[b, dev])
        blocks.append(b)
    return pieces, blocks


def place(tree, specs, mesh: Mesh, *, name: str = "tree"):
    """A tensor, or every tensor of nested dicts of them, cut by its spec
    in ``specs`` (the same structure) over ``mesh``: a :class:`Placed`
    or a dict tree of them (module docstring).  ``name`` prefixes the
    leaf paths in errors."""
    if isinstance(tree, torch.Tensor):
        x = tree.detach()
        axes = _axes(specs, x.shape, mesh, name)
        return Placed(tuple(x.shape), axes, mesh,
                      *_cut(x, axes, mesh, copy=True))
    return {k: place(v, specs[k], mesh, name=f"{name}[{k!r}]")
            for k, v in tree.items()}


def gather(tree, device=None):
    """A :class:`Placed` tensor, or a dict tree of them, put back
    together, each block once, on ``device`` (default: the mesh's first
    position's)."""
    if isinstance(tree, Placed):
        dev = (torch.device(device) if device is not None
               else tree.mesh.devices.reshape(-1)[0])
        out = torch.empty(tree.shape, dtype=tree.dtype, device=dev)
        seen = set()
        for piece, b in zip(tree.pieces, tree.blocks):
            if b not in seen:
                seen.add(b)
                out[_slices(tree.shape, tree.spec, tree.mesh, b)].copy_(piece)
        return out
    return {k: gather(v, device) for k, v in tree.items()}


# ------------------------------ train states -------------------------------

def _port_spec(name: str, ndim: int, tree) -> tuple:
    """The spec of the port's parameter ``name`` (``ndim`` dimensions)
    from the reference's spec tree ``tree`` (module docstring)."""
    path, layer, transposed = convert.jax_place(name, "lm")
    spec = tree
    for k in path:
        spec = spec[k]
    rank = ndim + (layer is not None)
    spec = tuple(spec) + (None,) * (rank - len(spec))
    if layer is not None:
        if spec[0] is not None:
            raise ValueError(f"{name}: spec {spec} splits the stacked layer "
                             "axis")
        spec = spec[1:]
    return spec[::-1] if transposed else spec


def place_state(state: dict, specs: dict, mesh: Mesh) -> dict:
    """An LM train state ``{"params": Transformer, "opt", "step"}`` placed
    by the reference's state specs ``specs`` (a cell's ``in_specs[0]``,
    or :func:`placed_specs`'s) over ``mesh``: ``{"model": the module's
    structure on ``meta``, "params": {name: Placed}, "opt":
    AdamWState(step, m, v) with {name: Placed} moments, "step": int}``.
    The state is not changed; the pieces are copies."""
    model = state["params"]
    if not isinstance(model, Transformer):
        raise TypeError(f"place_state: an LM train state, not "
                        f"{type(model).__name__}")

    def placed(tensors, tree):
        return {n: place(t, _port_spec(n, t.dim(), tree), mesh, name=n)
                for n, t in tensors.items()}

    opt = state["opt"]
    with torch.device("meta"):
        structure = Transformer(model.cfg)
    return {"model": structure,
            "params": placed(dict(model.named_parameters()),
                             specs["params"]),
            "opt": optimizer.AdamWState(opt.step.clone(),
                                        placed(opt.m, specs["opt"].m),
                                        placed(opt.v, specs["opt"].v)),
            "step": state["step"]}


def gather_state(placed: dict, device=None) -> dict:
    """The train state of a placed one, on ``device`` (default: the
    mesh's first position's): a fresh module holding the gathered
    parameters, the moments gathered in fp32."""
    mesh = next(iter(placed["params"].values())).mesh
    dev = (torch.device(device) if device is not None
           else mesh.devices.reshape(-1)[0])
    model = copy.deepcopy(placed["model"]).to_empty(device=dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(gather(placed["params"][n], dev))
    opt = placed["opt"]
    return {"params": model,
            "opt": optimizer.AdamWState(opt.step.clone(), gather(opt.m, dev),
                                        gather(opt.v, dev)),
            "step": placed["step"]}


def _expert_axes(cell) -> tuple:
    """The mesh axes the cell's rules put the experts over (``()``: every
    position holds every expert)."""
    axes = cell.rules.get("expert")
    if not axes or not cell.args[0]["params"].cfg.moe_experts:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def placed_specs(cell) -> tuple:
    """(state specs, batch specs) of an LM train cell's placed step: the
    cell's ``in_specs``, except that under expert-parallel rules each
    expert leaf is cut over the rules' expert axes alone (the cell's
    specs keep the FSDP posture for them, as the reference's do)."""
    sspec, bspec = cell.in_specs
    if not _expert_axes(cell):
        return sspec, bspec
    ep = logical_to_spec((None, "expert", None, None), cell.rules)

    def experts_split(tree):
        layers = tree["layers"]
        moe = dict(layers["moe"]) | {k: ep for k in _EXPERT_LEAVES}
        return tree | {"layers": layers | {"moe": moe}}

    opt = sspec["opt"]
    return (sspec | {"params": experts_split(sspec["params"]),
                     "opt": opt._replace(m=experts_split(opt.m),
                                         v=experts_split(opt.v))}, bspec)


# ------------------------------ the step -----------------------------------

class _Within(nn.Module):
    """``fn(model)`` as a module call, so that ``functional_call`` can
    run it with the model's parameters replaced."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn(self.model)


def _within(model, leaves: dict, fn):
    """``fn(model)`` with ``model``'s parameters named in ``leaves``
    replaced by those tensors for the call (a recomputation in the
    backward included, when ``fn`` runs it)."""
    return torch.func.functional_call(
        _Within(model), {f"model.{n}": t for n, t in leaves.items()}, (fn,))


class _Coupling(moe_lib.Local):
    """The placed step's hook into its MoE layers (``moe.coupled``):
    while ``record`` it sums each layer's expert counts over the pieces;
    afterwards every layer's ``ce`` comes from those sums.  ``owners``
    maps a layer to its experts' owners at the current position,
    ``[(lo, hi, device, (w_gate, w_up, w_down))]`` in expert order; a
    layer missing from it computes its experts where it runs."""

    def __init__(self):
        super().__init__()
        self.record = True
        self.counts, self.slots, self.owners = {}, {}, {}

    def ce(self, layer, counts, slots):
        if self.record:
            if layer in self.counts:
                prev = self.counts[layer]
                self.counts[layer] = prev + counts.to(prev.device)
                self.slots[layer] += slots
            else:
                self.counts[layer], self.slots[layer] = counts, slots
            return super().ce(layer, counts, slots)
        return (self.counts[layer].float()
                / self.slots[layer]).to(counts.device)

    def experts(self, layer, buf, swiglu):
        owners = self.owners.get(layer)
        if owners is None:
            return super().experts(layer, buf, swiglu)
        return torch.cat([swiglu(buf[:, lo:hi].to(dev), *w).to(buf.device)
                          for lo, hi, dev, w in owners], dim=1)


def _check_blocks(tokens: Placed) -> None:
    """A position's dispatch blocks must be the batch's blocks cut by
    rows (``moe.n_blocks``; the positions' rows are contiguous)."""
    T = tokens.shape[0] * tokens.shape[1]
    tb = T // moe_lib.n_blocks(T, moe_lib.BLOCK_TOKENS)
    piece = tokens.pieces[0]
    tp = piece.numel() // moe_lib.n_blocks(piece.numel(),
                                           moe_lib.BLOCK_TOKENS)
    if tp != tb:
        raise ValueError(
            f"placed MoE step: a position's {tuple(piece.shape)} tokens "
            f"dispatch in blocks of {tp} tokens, the batch's "
            f"{tokens.shape} in blocks of {tb}; each position must hold "
            f"whole blocks of {moe_lib.BLOCK_TOKENS}")


def _owners(model, params: dict, axes: tuple) -> dict:
    """{MoE layer: its expert leaves' names}, each leaf checked to be
    placed over the expert axes ``axes`` alone."""
    layers = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, moe_lib.MoE):
            names = tuple(f"{prefix}.{k}" for k in _EXPERT_LEAVES)
            for n in names:
                if params[n].spec != (axes, (), ()):
                    raise ValueError(
                        f"expert-parallel step: {n} is placed by "
                        f"{params[n].spec}; its experts must be cut over "
                        f"{axes} alone (placed_specs)")
            layers[mod] = names
    return layers


def placed_step(cell, *,
                opt_cfg: optimizer.AdamWConfig = optimizer.CELL_CONFIG):
    """``step(placed_state, placed_batch) -> (placed_state, metrics)`` of
    an LM train cell (module docstring), over the mesh of the cell's
    rules (``"__mesh__"``) or else the cell's own; the state placed by
    :func:`place_state` and the batch by :func:`place` with
    :func:`placed_specs`.  ``opt_cfg`` defaults to the cells'
    ``optimizer.CELL_CONFIG``, and the aux weight is ``lm_loss_fn``'s, as
    in the cell's own step.  Metrics: ``loss`` (the pieces' next-token losses
    summed in order over their count), ``grad_norm`` and ``lr`` as
    ``lm_train_step``'s, and ``load_balance`` and ``router_z``, the
    pieces' aux means likewise (zeros on a dense model).  Variants:
    ``rs_grads`` is the baseline's step (in one controller the pinned
    reduce-scatter is the cut of the reduced gradients), ``attn_remat``
    runs as its cell builds the model, and expert-parallel rules split
    the experts (module docstring).  Raises ``ValueError`` for a cell
    that is not an LM train cell or has no mesh."""
    state = cell.args[0] if cell.args else None
    if cell.kind != "train" or not (isinstance(state, dict) and isinstance(
            state.get("params"), Transformer)):
        raise ValueError(f"placed_step: {cell.arch_id} {cell.shape_id} is "
                         "not a train cell of the LM family")
    mesh = cell.rules.get("__mesh__", cell.mesh)
    if mesh is None:
        raise ValueError(f"placed_step: {cell.arch_id} {cell.shape_id} has "
                         "no mesh to place its step over")
    expert_axes = _expert_axes(cell)
    positions = _positions(mesh)
    root = positions[0][1]

    def step(state, batch):
        model, params, opt = state["model"], state["params"], state["opt"]
        tokens = batch["tokens"]
        if tokens.mesh != mesh or any(p.mesh != mesh
                                      for p in params.values()):
            raise ValueError("placed_step: the state and the batch must be "
                             f"placed over the cell's mesh {mesh}")
        if tokens.spec[1]:
            raise ValueError(f"placed_step: tokens placed by {tokens.spec}; "
                             "the step splits the batch, not the sequence")
        seen, runs = set(), []
        for i, b in enumerate(tokens.blocks):
            if b not in seen:
                seen.add(b)
                runs.append(i)
        moe = bool(model.cfg.moe_experts)
        if moe:
            _check_blocks(tokens)
        experts = _owners(model, params, expert_axes) if expert_axes else {}
        held = {n for names in experts.values() for n in names}
        hook = _Coupling()
        cache = {}

        def leaves(dev):
            """The parameters but the owned experts, gathered onto
            ``dev`` once a run of positions on it."""
            if dev not in cache:
                cache.clear()
                cache[dev] = {n: gather(p, dev).requires_grad_()
                              for n, p in params.items() if n not in held}
            return cache[dev]

        def own(i, grad):
            """Position i's owners of every layer's experts (the positions
            of its coordinates off the expert axes), as the hook takes
            them, and [(name, lo, hi, leaf)] of their pieces."""
            coords = positions[i][0]
            mine = [j for j, (c, _) in enumerate(positions)
                    if all(c[a] == v for a, v in coords.items()
                           if a not in expert_axes)]
            table, ep_leaves = {}, []
            for layer, names in experts.items():
                E = params[names[0]].shape[0]
                w = E // _count(expert_axes, mesh)
                table[layer] = []
                for j in sorted(mine, key=lambda j: params[
                        names[0]].blocks[j][0]):
                    lo = params[names[0]].blocks[j][0] * w
                    ws = tuple(params[n].pieces[j].detach().requires_grad_(
                        grad) for n in names)
                    table[layer].append((lo, lo + w, positions[j][1], ws))
                    ep_leaves += [(n, lo, lo + w, t)
                                  for n, t in zip(names, ws)]
            return table, ep_leaves

        if moe:        # the routing pass: every layer's expert counts
            with torch.no_grad(), moe_lib.coupled(hook):
                for i in runs:
                    hook.owners = own(i, False)[0]
                    _within(model, leaves(positions[i][1]),
                            lambda m, t=tokens.pieces[i]: m.hidden_states(
                                t, backend=train_step.PLAIN))
            hook.record = False

        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=root)
               for n, p in params.items()}
        zero = torch.zeros((), device=root)
        loss, aux_sum = zero, {"load_balance": zero, "router_z": zero}
        with moe_lib.coupled(hook):
            for i in runs:
                lv = leaves(positions[i][1])
                hook.owners, ep_leaves = own(i, True)
                inputs = list(lv.values()) + [t for *_, t in ep_leaves]

                def run(m, t=tokens.pieces[i], inputs=inputs):
                    total, l_mb, aux = train_step.lm_loss_fn(m, t)
                    return (torch.autograd.grad(total, inputs,
                                                allow_unused=True),
                            l_mb.detach(), aux)

                grads, l_mb, aux = _within(model, lv, run)
                for n, g in zip(lv, grads):
                    if g is not None:
                        acc[n].add_(g.to(root))
                for (n, lo, hi, _), g in zip(ep_leaves, grads[len(lv):]):
                    if g is not None:
                        acc[n][lo:hi].add_(g.to(root))
                loss = loss + l_mb.to(root)
                aux_sum = {k: v + aux[k].detach().to(root)
                           for k, v in aux_sum.items()}
                del grads, l_mb, aux
        del cache
        n_pieces = len(runs)
        grads = {n: g / n_pieces for n, g in acc.items()}
        del acc
        names = list(params)
        gnorm = optimizer.global_norm([grads[n] for n in names])
        ranks = convert.jax_ranks(dict(model.named_parameters()), "lm")
        cuts = {n: _cut(grads[n], params[n].spec, mesh, copy=False)[0]
                for n in names}
        done, new = set(), None
        for i, (_, dev) in enumerate(positions):
            todo = [n for n in names if (id(params[n].pieces[i]),
                                         id(opt.m[n].pieces[i]),
                                         id(opt.v[n].pieces[i])) not in done]
            if not todo:
                continue
            done.update((id(params[n].pieces[i]), id(opt.m[n].pieces[i]),
                         id(opt.v[n].pieces[i])) for n in todo)
            _, new, stats = optimizer.apply(
                opt_cfg, {n: params[n].pieces[i] for n in todo},
                {n: cuts[n][i] for n in todo},
                optimizer.AdamWState(opt.step,
                                     {n: opt.m[n].pieces[i] for n in todo},
                                     {n: opt.v[n].pieces[i] for n in todo}),
                ranks=ranks, gnorm=gnorm.to(dev))
        metrics = {"loss": loss / n_pieces, "grad_norm": gnorm,
                   "lr": stats["lr"],
                   **{k: v / n_pieces for k, v in aux_sum.items()}}
        return ({"model": model, "params": params,
                 "opt": optimizer.AdamWState(new.step, opt.m, opt.v),
                 "step": state["step"] + 1}, metrics)

    return step
