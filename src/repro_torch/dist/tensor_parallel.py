"""Tensor parallelism over the mesh's ``model`` axis: the port's
counterpart of what GSPMD does to the reference's jitted step when
``default_rules`` shard a weight's ``heads``, ``kv_heads``, ``mlp``,
``vocab``, ``inner``, ``heads_x_dim``, ``embed_out``, ``experts`` or
``expert_mlp`` dim over ``model``.

What splits is read from the rules, with no knob of its own: for each
weight, ``spec_for(whole shape, logical axes, default_rules(multi_pod),
mesh)`` decides, with the reference's degradation ladder.  A region runs
split over ``model`` exactly where its weights' specs shard a dim over
``model`` (and, for the two scan families, where its heads divide too),
and whole on every model rank otherwise (``split_plan``):

- attention (the dense, vision-language and audio families' layers and
  the hybrid's shared block): the q heads (``wq``, ``bq``, ``wo``) and,
  where they divide too, the kv heads (``wk``, ``wv``, ``bk``, ``bv``),
  column-parallel in Megatron's form, with a row-parallel ``wo`` whose
  partial sums are all-reduced.  Where the q heads split and the kv heads
  do not (llama3-405b at 16: 8 q heads a rank over 8 kv heads), ``wk``
  and ``wv`` stay whole: a training forward computes k and v for its own
  q heads' kv groups only, and the prefill and decode compute all of them
  for the cache, which stays whole, as the reference's spec keeps it;
- the SwiGLU MLP: ``w_gate`` and ``w_up`` column-parallel, ``w_down``
  row-parallel;
- Mamba2 (``inner``): the fused ``w_in`` [z | x | B | C | dt] cut by an
  index map (``params.cut_ranges`` over ``Mamba2``'s segments): each rank
  keeps the z and x columns and the dt column of its H / n heads and its
  2N / n of the B and C columns, and ``conv_w``, ``conv_b`` and the conv
  state its x and B/C channels; after the conv each rank's B/C channels
  are gathered (``gather_shared``), ``ssd_scan`` runs on the rank's
  heads, the gated norm sums its squares over ``model`` (``sum_partial``)
  and ``w_out`` is row-parallel.  Where the heads or the B/C columns do
  not divide, Mamba2 runs whole;
- RWKV6's time mix (``heads_x_dim``, ``heads``): ``w_r``, ``w_k``,
  ``w_v``, ``w_g`` column-parallel and ``u`` by heads, the decay's LoRA
  output and ``w_base`` read at the rank's columns, the WKV scan on the
  rank's heads, ``ln_x``'s norm over the whole width (``sum_partial``),
  ``w_o`` row-parallel; its channel mix (``mlp``, ``embed_out``):
  ``w_ck`` column-parallel, ``w_cv`` row-parallel, ``w_cr`` by columns,
  the rank's columns of the output gathered (``gather_from``);
- MLA (``heads``): ``wq_b`` and ``wkv_b`` column-parallel by heads,
  ``wo`` row-parallel; ``wq_a``, ``wkv_a`` and the latent cache stay
  whole, as the reference's specs keep them, and the split starts after
  them: the q latent and the KV latents enter it (``copy_to``), so that
  ``wq_a`` and ``wkv_a`` take whole, equal gradients on every rank;
  prefill attends over the rank's heads, the absorbed decode reads the
  rank's heads of ``wkv_b``;
- the mixture of experts (``experts``, else ``expert_mlp``): each rank
  keeps the ``w_gate``, ``w_up`` and ``w_down`` of its E / n experts or,
  where the experts do not divide (mixtral-8x22b's 8 at 16), each
  expert's columns of ``w_gate`` and ``w_up`` and rows of ``w_down``;
  the routing runs replicated on every model rank, the tokens and gates
  enter the experts through ``copy_to`` and each rank's partial outputs
  are summed over ``model`` (``models.moe.moe_forward``); the shared
  expert and the dense FFNs split by ``mlp`` as the MLP does;
- the vocabulary: the embedding (and the codebook embeddings) cut by rows,
  each rank looking up its own rows, zeros for tokens outside them, summed
  over ``model``; the head cut by columns (a tied head follows the
  embedding's cut); the cross-entropy vocab-parallel in float32
  (``vocab_cross_entropy``), so that the float32 logits are never
  gathered on the train path; ``prefill`` and ``decode`` gather the last
  position's logits, (B, 1, V), as the reference's batch-only
  ``out_shardings`` give them.

Conjugate ``autograd.Function``s carry the gradients: ``copy_to``
(identity forward, all-reduce backward) where a replicated activation
enters a split region, or a replicated weight is read in part, and
``reduce_from`` (all-reduce forward, identity backward) where its partial
sums leave it; ``sum_partial`` (all-reduce both ways) for a partial sum
that every rank reads whole, ``gather_shared`` (all-gather forward,
reduce-scatter backward) for blocks every rank reads whole, and
``gather_from`` (all-gather forward, the rank's block of the gradient
backward) for a replicated output assembled from blocks.  All run over
the ``model`` group only.  Every rank of a model group holds the same
replicated activations and parameters (the norms, a whole attention),
whose gradients are therefore equal on every rank; the split parameters'
are each rank's own.

``shard_model`` (``Model.shard``) cuts each split parameter to this rank's
block (``params.cut_params``) after the model was made whole, so the
seeded init and ``load_reference_params`` give every rank the unsplit
model's values in its block, bit for bit.

Collectives go through ``all_reduce`` and ``all_gather`` here, on any
backend: NCCL across cards, or gloo, which takes CUDA tensors itself
(two processes sharing one card, which NCCL refuses as a duplicate GPU),
while the kernels still run on the card.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import (ShardingReport, axis_sizes,
                                       default_rules, spec_for)
from repro_torch.models.params import assemble, cut_params, whole_shape

MODEL = "model"


# ----------------------------- collectives ---------------------------- #
@dataclasses.dataclass(frozen=True, eq=False)
class ModelGroup:
    """The ``model`` axis of a mesh as one rank sees it: its process
    group, its size and this rank's coordinate on it (or, for the MoE
    routing's ``BatchRouting``, the batch group: the functions below take
    either)."""
    group: object
    size: int
    rank: int


def all_reduce(t: torch.Tensor, mg: ModelGroup, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` (contiguous) all-reduced over the model group in place;
    returns it."""
    dist.all_reduce(t, op=op, group=mg.group)
    return t


def _gather_parts(t: torch.Tensor, mg: ModelGroup) -> list[torch.Tensor]:
    """Every model rank's ``t``, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mg.size)]
    dist.all_gather(parts, t, group=mg.group)
    return parts


def all_gather(t: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    """Every model rank's ``t`` concatenated along ``dim`` in rank order."""
    return torch.cat(_gather_parts(t, mg), dim=dim)


def _own_block(t: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    """This rank's block of ``mg.size`` equal blocks of ``t`` along
    ``dim``."""
    size = t.shape[dim] // mg.size
    return t.narrow(dim, mg.rank * size, size)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward over the model group."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mg), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward over the model group, identity backward."""

    @staticmethod
    def forward(ctx, x, mg):
        return all_reduce(x.contiguous().clone(), mg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumPartial(torch.autograd.Function):
    """All-reduce forward and backward over the model group."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return all_reduce(x.contiguous().clone(), mg)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mg), None


class _GatherShared(torch.autograd.Function):
    """All-gather forward along ``dim``; backward the gradient summed over
    the model group, this rank's block kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return all_gather(x, mg, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.mg)
        return _own_block(g, ctx.mg, ctx.dim).contiguous(), None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather forward along ``dim``; backward this rank's block of the
    gradient."""

    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return all_gather(x, mg, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.mg, ctx.dim).contiguous(), None, None


def copy_to(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """A replicated activation (or a replicated weight read in part) as it
    enters a split region: equal values, its gradient summed over the
    model group."""
    return _CopyToModel.apply(x, mg)


def reduce_from(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """A split region's partial sums, summed over the model group."""
    return _ReduceFromModel.apply(x, mg)


def sum_partial(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """A rank's partial sum that every rank reads whole (a norm's sum of
    squares over the rank's columns), summed over the model group; its
    gradient, each rank's part of it, summed too."""
    return _SumPartial.apply(x, mg)


def gather_shared(x: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    """Each rank's block of an activation that every rank reads whole
    (Mamba2's B and C channels), concatenated along ``dim``; the gradient
    of a block is the sum over the ranks' gradients of the whole, at the
    block."""
    return _GatherShared.apply(x, mg, dim)


def gather_from(x: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    """Each rank's block of a replicated output (RWKV6's channel-mix
    output), concatenated along ``dim``; the gradient of the whole, equal
    on every rank, gives each block its part."""
    return _GatherFrom.apply(x, mg, dim)


def split_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   mg: ModelGroup) -> torch.Tensor:
    """``layers.rms_norm`` over the whole width of an activation whose last
    dim is split over the model group: ``x`` and ``weight`` are this
    rank's columns; the sum of squares is summed over the group
    (``sum_partial``) and divided by the whole width."""
    dt = x.dtype
    x = x.float()
    ss = sum_partial((x * x).sum(-1, keepdim=True), mg)
    x = x * torch.rsqrt(ss / (x.shape[-1] * mg.size) + eps)
    return (x * weight.float()).to(dt)


# ------------------------------- regions ------------------------------ #
@dataclasses.dataclass(eq=False)
class RegionSplit:
    """A region split over ``model``: a replicated activation enters it
    (``copy_to``), its partial sums leave it (``reduce_from``), and a
    replicated weight or activation is read at this rank's block
    (``part``)."""
    mg: ModelGroup

    def enter(self, x):
        return copy_to(x, self.mg)

    def exit(self, y):
        return reduce_from(y, self.mg)

    def part(self, t, dim: int):
        """This rank's block of the replicated ``t`` along ``dim``, its
        gradient summed over the model group."""
        return _own_block(copy_to(t, self.mg), self.mg, dim)

    def rms_norm(self, x, weight, eps: float):
        """``layers.rms_norm`` over the whole width of which ``x`` and
        ``weight`` are this rank's columns (``split_rms_norm``)."""
        return split_rms_norm(x, weight, eps, self.mg)


@dataclasses.dataclass(eq=False)
class MlpSplit(RegionSplit):
    """A SwiGLU MLP whose ``mlp`` dim splits over ``model`` (``FFN.tp``)."""


@dataclasses.dataclass(eq=False)
class AttentionSplit(MlpSplit):
    """A GQA block whose q heads split over ``model`` (``GQA.tp``).
    ``kv_index``: None where the kv heads split too; else the whole kv
    heads this rank's q heads attend, one a group of its q heads
    (contiguous where each group is whole on the rank, one a q head
    otherwise)."""
    kv_index: tuple[int, ...] | None = None

    def kv_weights(self, *ws):
        """``wk``, ``wv`` and their biases (whole, replicated) cut to the
        kv heads this rank attends, their gradients summed over the model
        group; as they are where the kv heads split."""
        if self.kv_index is None:
            return ws
        return tuple(None if w is None else self._select(
            copy_to(w, self.mg), w.dim() - 2) for w in ws)

    def attended(self, kv):
        """The kv heads this rank attends of whole keys or values (B, S,
        Hkv, hd); ``kv`` itself where the kv heads split."""
        return kv if self.kv_index is None else self._select(kv, 2)

    def _select(self, t, dim):
        lo, n = self.kv_index[0], len(self.kv_index)
        if self.kv_index == tuple(range(lo, lo + n)):
            return t.narrow(dim, lo, n)
        return t.index_select(dim, torch.tensor(self.kv_index,
                                                device=t.device))


@dataclasses.dataclass(eq=False)
class MlaSplit(RegionSplit):
    """An MLA block whose heads split over ``model`` (``MLA.tp``): the q
    latent and the KV latents enter (``enter``), ``wq_b``, ``wkv_b`` and
    ``wo`` are this rank's heads."""


@dataclasses.dataclass(eq=False)
class ExpertSplit(RegionSplit):
    """A mixture of experts split over ``model`` (``MoE.tp``): by experts
    where ``by_experts`` (each rank keeps E / n), else by each expert's
    ``expert_mlp`` columns."""
    by_experts: bool = True

    def experts(self, n_experts: int) -> tuple[int, int]:
        """(the first, the number of) the experts this rank runs."""
        if not self.by_experts:
            return 0, n_experts
        n = n_experts // self.mg.size
        return self.mg.rank * n, n


@dataclasses.dataclass(eq=False)
class MambaSplit(RegionSplit):
    """A Mamba2 block whose heads split over ``model`` (``Mamba2.tp``):
    its parameters cut by ``Mamba2``'s segments, B and C gathered after
    the conv (``gather_bc``), the (H,) leaves read at the rank's heads
    (``part``), the gated norm over the whole ``d_inner``."""

    def gather_bc(self, bc):
        """The B and C channels (..., 2N) from each rank's (..., 2N / n)."""
        return gather_shared(bc, self.mg, -1)


@dataclasses.dataclass(eq=False)
class RwkvSplit(RegionSplit):
    """An RWKV6 layer split over ``model`` (``Rwkv6.tp``): its time mix
    by heads where ``time``, its channel mix by ``mlp`` and ``embed_out``
    columns where ``channel``."""
    time: bool = True
    channel: bool = True

    def gather(self, y):
        """A replicated output (..., d) from each rank's (..., d / n)."""
        return gather_from(y, self.mg, -1)


def local_lookup(table: torch.Tensor, ids: torch.Tensor, lo: int
                 ) -> torch.Tensor:
    """Rows ``ids - lo`` of ``table`` (this rank's rows ``lo`` to ``lo +
    len(table)`` of the whole vocabulary), zeros for ids outside them: no
    id indexes out of range."""
    local = ids - lo
    own = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(own, local, torch.zeros_like(local))]
    return rows.masked_fill(~own[..., None], 0)


@dataclasses.dataclass(eq=False)
class VocabSplit(MlpSplit):
    """A vocabulary split over ``model`` by rows of the embedding and
    columns of the head (``Model.tp``): this rank owns ids ``lo`` to
    ``lo + n_local``; the final norm's output enters the head
    (``enter``)."""
    lo: int = 0
    n_local: int = 0

    def lookup(self, table, ids):
        """The embedding of ``ids``: each rank's rows, summed over the
        model group.  Exactly one rank gives each token a non-zero row, so
        the sum is that row exactly."""
        return reduce_from(local_lookup(table, ids, self.lo), self.mg)

    def gather(self, logits):
        """Logits (..., V) whole from each rank's (..., V / n)."""
        return all_gather(logits, self.mg, dim=-1)

    def cross_entropy(self, logits, labels):
        """``models.model.cross_entropy`` of the rank's logit columns
        (``vocab_cross_entropy``)."""
        return vocab_cross_entropy(logits, labels, self)


class _VocabCrossEntropy(torch.autograd.Function):
    """Mean next-token CE of vocab-split logits, in float32, with the
    reference's arithmetic (``jax.nn.logsumexp`` minus the gold logit):
    the max of the local maxima (a MAX all-reduce), the log of the sum of
    the local sums of exp(logit - max) (a SUM), plus the max; the gold
    logit from the rank that owns it (a SUM of it and zeros).  The
    backward is softmax minus one-hot on the rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, vs):
        x = logits.to(torch.float32)
        if x is logits:
            x = x.clone()
        m = x.amax(dim=-1)
        all_reduce(m, vs.mg, dist.ReduceOp.MAX)
        local = labels.long() - vs.lo
        own = (local >= 0) & (local < vs.n_local)
        idx = torch.where(own, local, torch.zeros_like(local))
        gold = torch.gather(x, -1, idx[..., None])[..., 0]
        gold = all_reduce(torch.where(own, gold, torch.zeros_like(gold)),
                          vs.mg)
        x.sub_(m[..., None]).exp_()              # in place: the exp
        s = all_reduce(x.sum(dim=-1), vs.mg)
        logz = torch.log(s) + m
        x.div_(s[..., None])                     # the softmax, for backward
        ctx.save_for_backward(x, idx, own)
        ctx.dtype = logits.dtype
        return torch.mean(logz - gold)

    @staticmethod
    def backward(ctx, g):
        p, idx, own = ctx.saved_tensors
        # in place: the softmax is read once
        p.scatter_add_(-1, idx[..., None], -own[..., None].to(p.dtype))
        p.mul_(g / own.numel())
        return p.to(ctx.dtype), None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        vs: VocabSplit) -> torch.Tensor:
    """Mean CE of logits (B, S, V / n) or (B, S, CB, V / n), this rank's
    columns of the vocabulary, against labels shaped like them without V:
    equal on every model rank, and equal to ``cross_entropy`` of the whole
    logits to float32 rounding."""
    return _VocabCrossEntropy.apply(logits, labels, vs)


# -------------------------------- plan -------------------------------- #
# each region's weights, by leaf name: the first leaf found decides (the
# rest share its dim), and a region whose leaves the model lacks stays
# whole.  ``heads`` are the attention's q heads (MLA's ``wq_b``), or
# RWKV6's heads (``u``)
REGIONS = {"heads": ("attn.wq", "attn.wq_b", "time.u"),
           "kv_heads": ("attn.wk",), "mlp": ("ffn.w_gate", "time.w_ck"),
           "experts": ("moe.w_gate",), "expert_mlp": ("moe.w_gate",),
           "vocab": ("embedding",), "inner": ("mixer.w_in",),
           "heads_x_dim": ("time.w_r",), "embed_out": ("time.w_cr",)}
# what runs split, by family: (name, the regions that must all split)
RUNS = {"dense": (("attention", ("heads",)), ("mlp", ("mlp",)),
                  ("vocab", ("vocab",))),
        "hybrid": (("mamba2", ("inner",)), ("attention", ("heads",)),
                   ("mlp", ("mlp",)), ("vocab", ("vocab",))),
        "rwkv6": (("time mix", ("heads_x_dim", "heads")),
                  ("channel mix", ("mlp", "embed_out")),
                  ("vocab", ("vocab",))),
        "moe": (("attention", ("heads",)), ("experts", ("experts",)),
                ("expert mlp", ("expert_mlp",)), ("vocab", ("vocab",))),
        "mla": (("mla", ("heads",)), ("mlp", ("mlp",)),
                ("experts", ("experts",)), ("expert mlp", ("expert_mlp",)),
                ("vocab", ("vocab",)))}


@dataclasses.dataclass
class SplitPlan:
    """What runs split over the ``model`` axis of ``n`` ranks: each
    region's weight dim (``dims``) and whether it runs split (``split``:
    ``spec_for`` shards it, and ``why`` holds no reason to keep it whole).
    ``specs``: each parameter's spec on its whole shape; ``report``: the
    ShardingReport of those specs."""
    n: int
    split: dict[str, bool]
    dims: dict[str, int]
    specs: dict
    report: ShardingReport
    kind: str = "dense"
    why: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def any(self) -> bool:
        return any(self.split.values())

    def runs(self) -> dict[str, bool]:
        """{what runs (attention, mlp, mamba2, time mix, ...): split}."""
        return {name: all(self.split.get(r, False) for r in regions)
                for name, regions in RUNS[self.kind]}

    def describe(self) -> str:
        parts = []
        for region in REGIONS:
            if region not in self.dims:
                continue
            d = self.dims[region]
            parts.append(f"{region} {d} " + (
                f"split, {d // self.n} a rank" if self.split[region]
                else f"whole ({self.why[region]})" if region in self.why
                else f"whole ({d} % {self.n} != 0)"))
        return (f"model axis {self.n}: " + "; ".join(parts) + " -> "
                + ", ".join(f"{k} {'split' if v else 'whole'}"
                            for k, v in self.runs().items()))


def _model_dim(spec) -> int | None:
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else entry or ()
        if MODEL in axes:
            return dim
    return None


def _kind(cfg) -> str:
    if cfg.rwkv:
        return "rwkv6"
    if cfg.family in ("ssm", "hybrid"):
        return "hybrid"
    if cfg.attn_type == "mla":
        return "mla"
    return "moe" if cfg.n_experts else "dense"


def _kept_whole(cfg, kind: str, n: int, split: dict) -> dict[str, str]:
    """The regions that ``spec_for`` shards but whose heads do not divide
    over ``n`` ranks, with the reason: Mamba2 needs its heads and its B/C
    columns to, RWKV6's time mix its heads, and its channel mix both its
    ``mlp`` and ``embed_out`` dims; and ``expert_mlp`` where it would
    divide but the experts take ``model`` (one mesh axis a tensor)."""
    why = {}
    if split.get("experts"):
        why["expert_mlp"] = "the experts take model"
    if kind == "hybrid" and split.get("inner"):
        H, bc = cfg.ssm_heads, 2 * cfg.ssm_state
        if H % n or bc % n:
            why["inner"] = (f"{H} ssm heads and {bc} B/C columns do not "
                            f"both split into {n}")
    if kind == "rwkv6":
        if split.get("heads_x_dim") and not split.get("heads"):
            why["heads_x_dim"] = (f"{cfg.d_model // cfg.head_dim} heads do "
                                  f"not split into {n}")
        if split.get("mlp") != split.get("embed_out"):
            for r in ("mlp", "embed_out"):
                if split.get(r):
                    why[r] = "the channel mix splits mlp and embed_out or neither"
    return why


def split_plan(model, mesh) -> SplitPlan:
    """Which regions of ``model`` split over ``mesh``'s ``model`` axis, by
    ``spec_for`` of every parameter's whole shape under
    ``default_rules("pod" in the mesh)``, the heads' divisibility for the
    scan families, and ``expert_mlp`` left whole where the experts split
    (``_kept_whole``)."""
    sizes = axis_sizes(mesh)
    n = sizes.get(MODEL, 1)
    rules = default_rules("pod" in sizes)
    report = ShardingReport()
    specs = {name: spec_for(whole_shape(p), p.logical_axes, rules, mesh,
                            report, name)
             for name, p in model.named_parameters()}
    split, dims = {}, {}
    for region, leaves in REGIONS.items():
        name = next((k for leaf in leaves for k in specs
                     if k == leaf or k.endswith("." + leaf)), None)
        if name is None:
            continue
        p = model.get_parameter(name)
        axis = p.logical_axes.index(region)
        dims[region] = whole_shape(p)[axis]
        split[region] = _model_dim(specs[name]) == axis
    kind = _kind(model.cfg)
    why = _kept_whole(model.cfg, kind, n, split)
    for region in why:
        split[region] = False
    return SplitPlan(n, split, dims, specs, report, kind, why)


def shard_model(model, mesh):
    """Cut ``model`` (made whole, filled or not) to this rank's blocks of
    every weight of a region its ``split_plan`` splits, and attach the
    regions that run split (``GQA.tp``, ``MLA.tp``, ``FFN.tp``,
    ``MoE.tp``, ``Mamba2.tp``, ``Rwkv6.tp``, ``Model.tp``); returns
    ``model``.  A model already cut, or a plan that splits nothing (one
    model rank), is left as it is.  (The ``data`` cut comes after it:
    ``dist.fsdp.shard_data``.)"""
    if getattr(model, "split_plan", None) is not None and model.split_plan.any:
        raise ValueError("the model is split already")
    plan = split_plan(model, mesh)
    model.split_plan = plan
    if not plan.any:
        return model
    mg = ModelGroup(mesh.get_group(MODEL), plan.n,
                    mesh.get_local_rank(MODEL))
    cuts = {}
    for name, spec in plan.specs.items():
        dim = _model_dim(spec)
        p = model.get_parameter(name)
        if dim is not None and plan.split.get(p.logical_axes[dim], False):
            cuts[name] = (dim, mg.rank, mg.size,
                          getattr(p, "segments", None))
    cut_params(model, cuts)
    cfg = model.cfg
    runs = plan.runs()
    experts = runs.get("experts") or runs.get("expert mlp")
    for layer in model.attention_layers():
        if runs.get("attention"):
            layer.attn.tp = AttentionSplit(mg, None if plan.split[
                "kv_heads"] else _kv_index(cfg, mg))
        if runs.get("mla"):
            layer.attn.tp = MlaSplit(mg)
        if hasattr(layer, "ffn") and runs.get("mlp"):
            layer.ffn.tp = MlpSplit(mg)
        if hasattr(layer, "moe"):
            if experts:
                layer.moe.tp = ExpertSplit(mg, runs["experts"])
            shared = getattr(layer.moe, "shared", None)
            if shared is not None and hasattr(shared.w_gate, "cut"):
                shared.tp = MlpSplit(mg)
    if runs.get("mamba2"):
        for layer in model.layers:
            layer.mixer.tp = MambaSplit(mg)
    if plan.kind == "rwkv6" and (runs["time mix"] or runs["channel mix"]):
        for layer in model.layers:
            layer.time.tp = RwkvSplit(mg, runs["time mix"],
                                      runs["channel mix"])
    if runs["vocab"]:
        n_local = cfg.vocab_size // mg.size
        model.tp = VocabSplit(mg, mg.rank * n_local, n_local)
    return model


def _kv_index(cfg, mg: ModelGroup) -> tuple[int, ...]:
    """The whole kv heads rank ``mg.rank``'s q heads attend, where the q
    heads split over ``mg.size`` ranks and the kv heads do not: one a
    group of its q heads where each group lies whole on the rank or holds
    all its q heads (a contiguous range), else one a q head."""
    per = cfg.n_heads // mg.size
    group = cfg.n_heads // cfg.n_kv_heads
    heads = range(mg.rank * per, (mg.rank + 1) * per)
    if per % group == 0 or group % per == 0:
        return tuple(sorted({h // group for h in heads}))
    return tuple(h // group for h in heads)


def gather_cut(t: torch.Tensor, p, mg: ModelGroup | None,
               dg: ModelGroup | None = None) -> torch.Tensor:
    """The whole value of a tensor cut as parameter ``p`` is (``p`` itself,
    its gradient, its optimizer state): gathered over the data group
    ``dg`` where ``p`` is cut over ``data`` (``p.data_cut``), then over the
    model group ``mg`` where it is cut over ``model`` (``p.cut``), each put
    back in place (``params.assemble``); as it is where ``p`` is not
    cut."""
    for cut, group in ((getattr(p, "data_cut", None), dg),
                       (getattr(p, "cut", None), mg)):
        if cut is not None:
            if group is None:
                raise ValueError("a tensor cut over a mesh axis needs that "
                                 "axis's group to be gathered")
            t = assemble(_gather_parts(t, group), cut)
    return t


def model_group(model) -> ModelGroup | None:
    """The model group of a split model (that of any region it runs
    split), or None."""
    for m in model.modules():
        region = getattr(m, "tp", None)
        if region is not None:
            return region.mg
    return None


__all__ = ["AttentionSplit", "ExpertSplit", "MambaSplit", "MlaSplit",
           "MlpSplit", "ModelGroup", "RegionSplit", "RwkvSplit", "SplitPlan",
           "VocabSplit", "all_gather", "all_reduce", "copy_to", "gather_cut",
           "gather_from", "gather_shared", "local_lookup", "model_group",
           "reduce_from", "shard_model", "split_plan", "split_rms_norm",
           "sum_partial", "vocab_cross_entropy"]
