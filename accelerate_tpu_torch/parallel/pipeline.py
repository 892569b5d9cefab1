"""Pipeline parallelism: a model's stacked layers split over the ``pipeline`` axis.

Counterpart of ``accelerate_tpu/parallel/pipeline.py`` on
``torch.distributed``. Any model with a per-layer hook (``pipeline_layer``:
llama, gpt2, bert, and T5's two stacks) runs its layers as a pipeline over
the processes of its pipeline group (``PartialState.pipeline_stages``):

- every process holds ``virtual_stages`` interleaved chunks of ``L/(vP)``
  layers, process ``p`` chunks ``c*P + p`` (Megatron's interleaved
  schedule; ``interleaved_spec`` stores the layers so), and activations hop
  stage to stage by point-to-point sends (``parallel/compat.Hop``), the last
  stage wrapping round to the first between chunks;
- the schedule is the JAX package's: a deep-first greedy simulation on the
  host (:func:`build_interleaved_schedule`, copied as it is) gives each
  process, at each tick, its chunk, whether it consumes the arrival or
  injects a microbatch, the microbatch, and what it emits. Each activation
  produced at tick ``t`` is consumed at ``t+1`` on the next stage, so one
  slot a process suffices;
- side inputs never ride the ring: a per-microbatch one (``"mb"``: masks,
  per-row rotary tables, T5's encoder output) enters whole on every stage
  and each tick indexes its microbatch; a broadcast one (``"bcast"``) is
  passed as it is;
- dropout draws from a seed folded from (base seed, global layer,
  microbatch) (:func:`fold_pipeline_dropout_rng`), and the sequence index
  under a sequence axis, so a recomputed chunk draws the same masks and a
  run without the pipeline that applies the same fold draws them too;
- the MoE balance term is summed over every executed chunk and the stages,
  then divided by the microbatch count (a mean over microbatches, as the
  JAX package's);
- every chunk is recomputed in the backward, its hops outside the
  recomputation (the JAX package's ``jax.checkpoint`` of the chunk).

The backward is written as the schedule reversed, tick by tick, in one
autograd function (:class:`_Pipeline`), where the JAX package gets it from
``jax.grad`` through its ``lax.scan``; the reversal is what XLA derives:

- each hop's gradient goes the other way round, at every tick, idle ones
  included: a process that skipped a hop's backward would leave its
  neighbour waiting. An arrival a tick does not consume sends a zero back
  (JAX keeps it on the graph through its ``where``); idle ticks skip the
  chunk's compute, never the hop;
- the outputs are the last stage's, broadcast to every stage (JAX's psum of
  zeros elsewhere); every stage computes the same loss from them, so the
  last stage takes the outputs' cotangent once, its own, and the others
  take none;
- ``h`` enters whole on every stage and only the first stage injects it, so
  its cotangent is the first stage's, broadcast; a side input's cotangent
  is summed over the stages (T5's relative-position tables feed every
  stage's layers). The leaves outside the layer stack (embeddings, final
  norm, head) thus get one process's gradient, the same on every stage.

bf16 activations hop as bf16. The JAX package widens them around its psums
only to get round an XLA crash; the values are the same.

Idle share: with v = 1 the schedule is GPipe's, ``(P-1)/(M+P-1)``; v chunks
a process cut each fill and drain tick to 1/v of a stage, and
:func:`build_interleaved_schedule` reports the exact share for (P, v, M).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..logging import get_logger
from ..utils.constants import MESH_AXIS_PIPELINE, MESH_AXIS_SEQUENCE
from .compat import Hop

logger = get_logger(__name__)

_MASK = 2**64 - 1
# a hook's default attention: the model's own ``attention_fn`` (a call from
# ``apply`` passes the one it resolved, None included)
OWN_HOOK = object()


def _mix(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit words."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def fold_seed(seed: int, data: int) -> int:
    """A seed below 2**62 (as ``models.attention.draw_seeds`` draws them)
    folded from ``seed`` and ``data``: the port's ``jax.random.fold_in`` on
    Python ints."""
    return _mix(_mix(int(seed) & _MASK) ^ (int(data) & _MASK)) >> 2


def split_seed(seed: int, n: int) -> list[int]:
    """``n`` seeds folded from ``seed`` (the port's ``jax.random.split``):
    one a dropout site of a layer."""
    return [fold_seed(seed, i) for i in range(n)]


def fold_pipeline_dropout_rng(base: int, layer_index: int, microbatch: int) -> int:
    """The dropout seed of global layer ``layer_index`` on microbatch
    ``microbatch`` inside the schedule, from the call's ``base`` seed.
    Deterministic in (layer, microbatch), so a recomputed chunk replays its
    masks and a run without the pipeline that applies the same fold to
    each microbatch draws them too. The masks differ from the JAX
    package's (threefry against Philox); the rule is the same."""
    return fold_seed(fold_seed(base, layer_index), microbatch)


def build_interleaved_schedule(num_stages: int, virtual: int, num_microbatches: int):
    """Static (device, tick) tables for the interleaved forward schedule.

    Deep-first greedy: each device consumes its ring arrival when one exists
    (arrivals are always deeper in the network than fresh injections), else
    device 0 injects the next microbatch into virtual stage 0. Every
    activation produced at tick t is consumed at tick t+1 on the next device
    of the ring — one in-flight slot per device, like GPipe.

    Returns ``(chunk, use_arrival, microbatch, emit, idle_fraction)`` — the
    first four are [P, T] int arrays (-1 = not applicable at that tick);
    ``microbatch`` records WHICH microbatch a device processes at each tick
    (valid wherever ``chunk >= 0``), used for side-input indexing and
    dropout-rng folding.
    """
    Pn, v, M = num_stages, virtual, num_microbatches
    S = v * Pn
    arrive: list = [None] * Pn
    next_inject = 0
    done = 0
    chunk_rows, use_rows, mb_rows, emit_rows = [], [], [], []
    while done < M:
        send: list = [None] * Pn
        cc, uu, mm, ee = [-1] * Pn, [0] * Pn, [-1] * Pn, [-1] * Pn
        for p in range(Pn):
            if arrive[p] is not None:
                m, s = arrive[p]
                cc[p], uu[p], mm[p] = s // Pn, 1, m
                if s == S - 1:
                    ee[p] = m
                    done += 1
                else:
                    send[(p + 1) % Pn] = (m, s + 1)
            elif p == 0 and next_inject < M:
                m = next_inject
                next_inject += 1
                cc[p], mm[p] = 0, m
                if S == 1:
                    ee[p] = m
                    done += 1
                else:
                    send[1 % Pn] = (m, 1)
        arrive = send
        chunk_rows.append(cc)
        use_rows.append(uu)
        mb_rows.append(mm)
        emit_rows.append(ee)
    T = len(chunk_rows)
    tables = tuple(
        np.asarray(rows, np.int32).T  # [T, P] → [P, T]
        for rows in (chunk_rows, use_rows, mb_rows, emit_rows)
    )
    busy = int((tables[0] >= 0).sum())
    idle_fraction = 1.0 - busy / float(Pn * T)
    return (*tables, idle_fraction)


def interleaved_spec(spec: tuple, virtual: int) -> tuple:
    """A stacked layer leaf's spec with its leading dim over ``pipeline``
    stored as ``virtual`` blocks (``parallel/sharding``'s block form), so
    that process ``p`` holds chunks ``c*P + p``, in chunk order; other
    specs as they are."""
    if virtual > 1 and spec and spec[0] == MESH_AXIS_PIPELINE:
        return ((virtual, MESH_AXIS_PIPELINE),) + tuple(spec[1:])
    return spec


def microbatch_count(requested: int, batch: int) -> int:
    """The microbatches a batch of ``batch`` rows runs as: ``requested``, cut
    to the largest count at most it that divides the batch."""
    count = min(requested, batch)
    while batch % count:
        count -= 1
    return count


class _Run:
    """What one call of the schedule needs besides its tensors."""

    def __init__(self, stages, layer_fn, names, virtual, chunk_size, microbatches, tables, kinds, seed,
                 seq_index, layer_kwargs):
        self.stages = stages
        self.layer_fn = layer_fn
        self.layer_kwargs = layer_kwargs
        self.names = names
        self.virtual = virtual
        self.chunk_size = chunk_size
        self.microbatches = microbatches
        self.chunk, self.use, self.mb, self.emit, self.idle = tables
        self.kinds = kinds
        self.seed = seed
        self.seq_index = seq_index

    def chunk_params(self, leaves: list, c: int) -> list:
        """Chunk ``c``'s slices of this process's ``[v * L/(vP), ...]`` leaves."""
        return [leaf.view(self.virtual, self.chunk_size, *leaf.shape[1:])[c] for leaf in leaves]

    def place(self, live, batch: int) -> list:
        """Every side input in its place (None where the call passed None)
        from the live ones (or tensors shaped like them, None where
        absent), a per-microbatch one viewed as ``[M, b/M, ...]``."""
        live = iter(live)
        out = []
        for kind in self.kinds:
            c = None if kind == "none" else next(live)
            if c is not None and kind == "mb":
                c = c.reshape(self.microbatches, batch // self.microbatches, *c.shape[1:])
            out.append(c)
        return out

    def side_inputs(self, consts: list, m: int) -> tuple:
        """The side inputs of a tick on microbatch ``m``: a per-microbatch
        one's slice ``m``, the others whole."""
        return tuple(c[m] if c is not None and kind == "mb" else c for c, kind in zip(consts, self.kinds))

    def compute(self, params: list, x: torch.Tensor, side: tuple, c: int, m: int):
        """Chunk ``c`` on microbatch ``m``'s activations ``x``: ``(y, aux)``,
        the aux summed over its layers (0.0 when no layer returns one)."""
        stage = c * self.stages.size + self.stages.index
        aux_sum = 0.0
        for j in range(self.chunk_size):
            seed = None
            if self.seed is not None:
                seed = fold_pipeline_dropout_rng(self.seed, stage * self.chunk_size + j, m)
                if self.seq_index is not None:  # each sequence chunk draws its own masks
                    seed = fold_seed(seed, self.seq_index)
            lp = {name: p[j] for name, p in zip(self.names, params)}
            x, aux = self.layer_fn(lp, x, seed, *side, **self.layer_kwargs)
            if isinstance(aux, torch.Tensor):
                aux_sum = aux_sum + aux.float()
            elif aux:
                aux_sum = aux_sum + float(aux)
        return x, aux_sum


def _wide(x: torch.Tensor) -> torch.dtype:
    """The dtype a gradient of ``x`` is summed in: fp32 for a narrower float."""
    return torch.float32 if x.is_floating_point() and x.element_size() < 4 else x.dtype


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd function: ``(run, h, *leaves, *consts)
    -> (outputs, aux)``. The forward runs every tick without a graph and
    keeps each executed chunk's input; the backward runs the ticks in
    reverse, recomputing each chunk with its graph and sending each hop's
    gradient back (module docstring)."""

    @staticmethod
    def forward(ctx, run: _Run, h, *tensors):
        stages = run.stages
        n = len(run.names)
        leaves, consts = list(tensors[:n]), run.place(tensors[n:], h.shape[0])
        mb_h = h.reshape(run.microbatches, h.shape[0] // run.microbatches, *h.shape[1:])
        outputs = torch.zeros_like(mb_h)
        aux_acc = torch.zeros((), dtype=torch.float32, device=h.device)
        p, ticks = stages.index, run.chunk.shape[1]
        arrival, saved = None, {}
        for t in range(ticks):
            c, use, m, e = (int(tab[p, t]) for tab in (run.chunk, run.use, run.mb, run.emit))
            y = None
            if c >= 0:
                x = arrival if use else mb_h[m]
                saved[t] = x
                y, aux = run.compute(run.chunk_params(leaves, c), x, run.side_inputs(consts, m), c, m)
                aux_acc = aux_acc + aux
                if e >= 0:
                    outputs[e] = y
            if stages.size > 1 and t < ticks - 1:
                send = y if y is not None else torch.zeros_like(mb_h[0])
                (arrival,) = Hop([send], stages.next, stages.prev, stages.group).wait()
        if stages.size > 1:
            # the last stage's outputs on every stage; the aux summed over the stages
            dist.broadcast(outputs, src=dist.get_global_rank(stages.group, stages.size - 1), group=stages.group)
            dist.all_reduce(aux_acc, group=stages.group)
        ctx.run, ctx.saved, ctx.h_shape, ctx.h_like = run, saved, h.shape, mb_h[0]
        ctx.save_for_backward(*tensors)
        return outputs.reshape(h.shape), aux_acc / run.microbatches

    @staticmethod
    def backward(ctx, grad_out, grad_aux):
        run, stages = ctx.run, ctx.run.stages
        n = len(run.names)
        tensors = ctx.saved_tensors
        leaves, live = list(tensors[:n]), list(tensors[n:])
        consts = run.place(live, ctx.h_shape[0])
        rows = ctx.h_shape[0] // run.microbatches
        shape = (run.microbatches, rows, *ctx.h_shape[1:])
        g_out = None if grad_out is None or not stages.last else grad_out.reshape(shape)
        aux_ct = None if grad_aux is None else grad_aux / run.microbatches
        needs = ctx.needs_input_grad[2:]
        # gradients summed over the microbatches in fp32, rounded to the
        # leaves' dtype once (autograd casts them back)
        g_leaves = [torch.zeros_like(leaf, dtype=_wide(leaf)) if need else None for leaf, need in zip(leaves, needs[:n])]
        g_chunks = [None if g is None else g.view(run.virtual, run.chunk_size, *g.shape[1:]) for g in g_leaves]
        g_live = [torch.zeros_like(c, dtype=_wide(c)) if need else None for c, need in zip(live, needs[n:])]
        g_consts = run.place(g_live, ctx.h_shape[0])
        g_h = None
        p, ticks = stages.index, run.chunk.shape[1]
        g_arrival = None  # the cotangent of the arrival at the end of tick t
        for t in reversed(range(ticks)):
            g_y = None
            if stages.size > 1 and t < ticks - 1:
                send = g_arrival if g_arrival is not None else torch.zeros_like(ctx.h_like)
                (g_y,) = Hop([send.contiguous()], stages.prev, stages.next, stages.group).wait()
            c, use, m, e = (int(tab[p, t]) for tab in (run.chunk, run.use, run.mb, run.emit))
            g_arrival = None
            if c < 0:
                continue
            if e >= 0 and g_out is not None:
                g_y = g_out[e] if g_y is None else g_y + g_out[e]
            x = ctx.saved[t].detach().requires_grad_()
            params = [q.detach().requires_grad_(need) for q, need in zip(run.chunk_params(leaves, c), needs[:n])]
            side = tuple(None if s is None else s.detach().requires_grad_(g is not None)
                         for s, g in zip(run.side_inputs(consts, m), run.side_inputs(g_consts, m)))
            with torch.enable_grad():
                y, aux = run.compute(params, x, side, c, m)
            outs, cts = [y], [torch.zeros_like(y) if g_y is None else g_y]
            if aux_ct is not None and isinstance(aux, torch.Tensor) and aux.requires_grad:
                outs.append(aux)
                cts.append(aux_ct)
            wrt = [x] + [q for q in params if q.requires_grad] + [s for s in side if s is not None and s.requires_grad]
            grads = list(torch.autograd.grad(outs, wrt, cts, allow_unused=True))
            g_x = grads.pop(0)
            for g_chunk, q in zip(g_chunks, params):
                if q.requires_grad:
                    g = grads.pop(0)
                    if g is not None:
                        g_chunk[c] += g
            for g_side, s in zip(run.side_inputs(g_consts, m), side):
                if s is not None and s.requires_grad:
                    g = grads.pop(0)
                    if g is not None:
                        g_side += g
            if use:
                g_arrival = g_x
            elif g_x is not None:
                if g_h is None:
                    g_h = torch.zeros(shape, dtype=g_x.dtype, device=g_x.device)
                g_h[m] += g_x
        if g_h is None:
            g_h = torch.zeros(shape, dtype=ctx.h_like.dtype, device=ctx.h_like.device)
        if stages.size > 1:
            # only the first stage injects: its cotangent of h is the whole one
            dist.broadcast(g_h, src=dist.get_global_rank(stages.group, 0), group=stages.group)
            for g in g_live:
                if g is not None:
                    dist.all_reduce(g, group=stages.group)
        return (None, g_h.reshape(ctx.h_shape), *g_leaves, *g_live)


def make_pipeline_layers_fn(
    cfg,
    state,
    num_microbatches: int,
    layer_fn: Optional[Callable] = None,
    virtual_stages: int = 1,
    seq_dims=None,
    const_kinds=None,
):
    """Build ``fn(stacked_layers, h, *consts, dropout_rng=None) -> (h, aux)``
    running a layer stack as a pipeline over ``state``'s pipeline group
    (``state`` a ``PartialState``; its ``mesh_shape`` sizes the schedule,
    and its group is taken at the first call).

    ``layer_fn(lp, h, seed, *consts) -> (h, aux)`` is the model's one-layer
    function (its ``pipeline_layer`` hook): ``lp`` one layer's params,
    ``seed`` the folded dropout seed or None, ``aux`` a scalar side loss (0
    for a dense layer, the MoE balance term for a routed one).
    ``stacked_layers`` is a dict of this process's stacked leaves, ``[v *
    L/(vP), ...]`` each, chunk by chunk (the stored layout,
    :func:`interleaved_spec`); ``dropout_rng`` the call's base seed (an
    int; the processes of the pipeline group must pass the same one:
    ``fn.replicas`` broadcasts a draw, ``models.attention.draw_seeds``);
    ``layer_kwargs`` pass through to every ``layer_fn`` call (the
    attention hook and ring ``apply`` resolved for this call).

    ``consts`` are side inputs forwarded to every layer call: None, passed
    as None; per-microbatch (``"mb"``: leading dim the batch's), sliced per
    tick; or broadcast (``"bcast"``), passed whole. ``const_kinds`` declares
    each (``"mb"``, ``"bcast"`` or None: inferred from the leading dim),
    the model's ``pipeline_const_kinds``: a batch-invariant const whose
    leading dim happens to equal the batch must be declared ``"bcast"``.

    ``seq_dims`` (the model's ``pipeline_seq_dims``) says the model runs
    its chunk of the sequence under a sequence axis (the activations and
    side inputs are already this process's chunk, and its attention is the
    ring over the sequence group, ``ring_attention.make_local_ring_attention``);
    without it a sequence axis raises. The layer count must divide into
    ``virtual_stages * pipeline``; the microbatch count is cut, with a
    warning, to the largest that divides the batch."""
    if layer_fn is None:
        raise TypeError(
            "make_pipeline_layers_fn needs the model's per-layer function "
            "(layer_fn=model.pipeline_layer) — the schedule is model-agnostic."
        )
    sizes = state.mesh_shape
    seq_size = sizes.get(MESH_AXIS_SEQUENCE, 1)
    if seq_size > 1 and seq_dims is None:
        raise NotImplementedError(
            "pipeline + sequence axes need the model to declare its sequence "
            "dimensions (pipeline_seq_dims) — this model does not"
        )
    nstages = sizes[MESH_AXIS_PIPELINE]
    v = virtual_stages
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    if const_kinds is not None:
        bad = [k for k in const_kinds if k not in (None, "mb", "bcast")]
        if bad:
            raise ValueError(f'const_kinds entries must be None, "mb" or "bcast"; got {bad}')
    if cfg.num_layers % (v * nstages) != 0:
        raise ValueError(
            f"num_layers={cfg.num_layers} must divide virtual_stages*pipeline "
            f"= {v}*{nstages}"
        )
    M = num_microbatches
    chunk_size = cfg.num_layers // (v * nstages)
    warned: set = set()

    def fn(stacked_layers: dict, h: torch.Tensor, *consts, dropout_rng: Optional[int] = None, **layer_kwargs):
        b = h.shape[0]
        declared = const_kinds if const_kinds is not None else (None,) * len(consts)
        if len(declared) != len(consts):
            raise ValueError(
                f"const_kinds declares {len(declared)} side inputs but the "
                f"pipeline call passed {len(consts)}"
            )
        kinds = tuple(
            "none"
            if c is None
            else (k or ("mb" if (c.dim() >= 1 and c.shape[0] == b) else "bcast"))
            for c, k in zip(consts, declared)
        )
        m_eff = microbatch_count(M, b)
        tables = build_interleaved_schedule(nstages, v, m_eff)
        if m_eff < M and b not in warned:  # once a batch size
            warned.add(b)
            logger.warning(
                f"pipeline: num_microbatches={M} cut to {m_eff} by batch {b} — "
                f"schedule idle fraction is {tables[-1]:.0%}. Raise the batch (or "
                "pick one divisible by the microbatch count) to shrink it."
            )
        names = list(stacked_layers)
        leaves = [stacked_layers[name] for name in names]
        for name, leaf in zip(names, leaves):
            if leaf.shape[0] != v * chunk_size:
                raise ValueError(
                    f"layers/{name}: leading dim {leaf.shape[0]}, expected this process's "
                    f"{v} chunks of {chunk_size} layers"
                )
        seq_index = state.mesh_coords[MESH_AXIS_SEQUENCE] if seq_size > 1 else None
        run = _Run(state.pipeline_stages(), layer_fn, names, v, chunk_size, m_eff, tables, kinds, dropout_rng,
                   seq_index, layer_kwargs)
        live = [c for c in consts if c is not None]
        return _Pipeline.apply(run, h, *leaves, *live)

    fn.virtual_stages = v
    fn.num_microbatches = M
    fn.replicas = None  # Accelerator.prepare_model sets the group that shares the base seed
    return fn
