"""Model assembly for the hybrid family (Zamba2: a Mamba2 stack with one
weight-shared attention(+MLP) block applied after every k-th layer), the
plain Mamba2 stack, the RWKV6 stack (``cfg.rwkv``) and the dense and MoE
families (a stack of GQA attention + SwiGLU or mixture-of-experts layers):
``forward``, ``prefill`` and ``decode`` as in ``repro.models.model.Model``,
and the training loss, ``cross_entropy`` and ``loss_fn``.  Attention is
GQA or, with ``attn_type`` "mla", DeepSeek-V3's multi-head latent
attention; a MoE config with
``first_k_dense`` runs that many dense-FFN layers (``dense_layers``) before
its MoE ``layers``, as the reference does.  The audio family (MusicGen)
runs the dense stack over ``n_codebooks`` token streams, whose embeddings
are summed and which each get their own logits; the vision-language family
(Qwen2-VL) runs it with M-RoPE over (3, B, S) position ids and takes
precomputed patch embeddings in place of its first positions (the vision
tower is a stub, as in the reference).

The layers are ``nn.Module``s run in a Python loop (the reference scans a
stacked tree); parameters keep the reference's names, so
``params.load_reference_params`` carries a JAX parameter tree over.  The
decode cache keeps the reference's stacked layout, and ``prefill`` and
``decode`` update it in place and return it; both run without autograd.
``forward`` runs with it, each layer under activation checkpointing when
``cfg.remat`` is set.

Cut over a mesh's ``data`` axis (``Model.shard``, ``dist.fsdp``), every
loop runs each layer on its parameters gathered whole over ``data``
(``Model._gathered``), dropped when the layer ends, and gathers the
embedding, the head, ``ln_f`` and the codebook tables where they are
read.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, resolve_use_kernel
from repro_torch.dist.fsdp import gathered, whole
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import (InitCtx, init_params, materialize,
                                       param_axes, whole_shape)
from repro_torch.trace import span


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        self.ln = ctx.param("ln", (cfg.d_model,), ("embed",), init="ones")
        self.mixer = ssm_mod.mamba2_init(cfg, ctx)


class RwkvLayer(nn.Module):
    """Pre-norm time mix and channel mix, both under ``time`` (the
    reference's ``_rwkv_layer_init``)."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        self.ln1 = ctx.param("ln1", (cfg.d_model,), ("embed",), init="ones")
        self.ln2 = ctx.param("ln2", (cfg.d_model,), ("embed",), init="ones")
        self.time = rwkv_mod.rwkv6_init(cfg, ctx)


class DenseLayer(nn.Module):
    """Pre-norm attention (GQA, or MLA by ``cfg.attn_type``) + SwiGLU MLP
    (``ffn``) or mixture of experts (``moe``): a layer of the dense and MoE
    stacks, and the hybrid's shared block."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx, use_moe: bool = False):
        super().__init__()
        self.ln1 = ctx.param("ln1", (cfg.d_model,), ("embed",), init="ones")
        self.ln2 = ctx.param("ln2", (cfg.d_model,), ("embed",), init="ones")
        self.attn = (attn.mla_init(cfg, ctx) if cfg.attn_type == "mla"
                     else attn.gqa_init(cfg, ctx))
        if use_moe:
            self.moe = moe_mod.moe_init(cfg, ctx)
        else:
            self.ffn = moe_mod.ffn_init(cfg, ctx)


_ATTENTION = {
    "gqa": {"train": attn.gqa_forward, "prefill": attn.gqa_prefill,
            "decode": attn.gqa_decode},
    "mla": {"train": attn.mla_forward, "prefill": attn.mla_prefill,
            "decode": attn.mla_decode},
}


def _dense_layer_fwd(p: DenseLayer, x: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor, mode: str, cache=None):
    """-> (x, the cache (updated in place; None in "train"), MoE aux)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    fwd = _ATTENTION["mla" if cfg.attn_type == "mla" else "gqa"][mode]
    with span("repro.attention"):
        if mode == "train":
            a, new_cache = fwd(p.attn, h, cfg, positions), None
        else:
            a, new_cache = fwd(p.attn, h, cfg, positions, cache)
    x = x + a
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    with span("repro.mlp"):
        if hasattr(p, "moe"):
            f, aux = moe_mod.moe_forward(p.moe, h, cfg)
        else:
            f, aux = moe_mod.ffn_forward(p.ffn, h), torch.zeros(
                (), dtype=torch.float32, device=x.device)
    return x + f, new_cache, aux


def _at(tree: dict, i: int) -> dict:
    """Views of entry ``i`` of a stacked cache (writes reach the stack)."""
    return {k: v[i] for k, v in tree.items()}


class Model(nn.Module):
    """A hybrid, plain Mamba2, RWKV6, dense or MoE (DeepSeek's MLA and
    first_k_dense stack included), audio (codebook streams) or
    vision-language (M-RoPE, vision stub) model on
    ``device`` (default: the card; raises without one unless
    ``device="cpu"``).  Parameters are allocated uninitialised; ``init``
    fills them from a seed, and ``params.load_reference_params`` from the
    JAX package's tree.  ``cfg.use_kernel`` None resolves to the kernels on
    CUDA.  With ``on_meta`` the parameters are made on the meta device
    (the model still belongs to ``device``), to be cut by ``shard`` and
    made on ``device`` by ``params.materialize`` (``build_model``)."""

    def __init__(self, cfg: ModelConfig, device=None, *,
                 on_meta: bool = False):
        super().__init__()
        dev = resolve_device(device)
        cfg = dataclasses.replace(
            cfg, use_kernel=resolve_use_kernel(cfg.use_kernel, dev))
        self.cfg = cfg
        self.device = dev
        # the vocabulary's split over a mesh's ``model`` axis and the plan
        # of every region's (``shard``); None: whole
        self.tp = None
        self.split_plan = None
        # the ``data`` group where the weights are cut over ``data``
        # (``shard``, ``dist.fsdp``); None: whole over it
        self.fsdp = None
        alloc = torch.device("meta") if on_meta else dev
        ctx = InitCtx(cfg.dtype, alloc)
        # the reference's ``embed`` leaf (``embed`` is the method here);
        # with codebooks it and ``head`` are kept unread, as the reference
        # keeps them
        self.embedding = ctx.param("embed", (cfg.vocab_size, cfg.d_model),
                                   ("vocab", "embed"), scale=0.02)
        self.ln_f = ctx.param("ln_f", (cfg.d_model,), ("embed",), init="ones")
        if not cfg.tie_embeddings:
            self.head = ctx.param("head", (cfg.d_model, cfg.vocab_size),
                                  ("embed", "vocab"), scale=0.02)
        if cfg.n_codebooks:
            CB, V, d = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
            self.embed_cb = ctx.param("embed_cb", (CB, V, d),
                                      (None, "vocab", "embed"), scale=0.02)
            self.head_cb = ctx.param("head_cb", (CB, d, V),
                                     (None, "embed", "vocab"), scale=0.02)
        # each stack's leaves take std 1/sqrt(that stack's depth)
        n = cfg.n_layers - self._first_dense
        stack = InitCtx(cfg.dtype, alloc, stack=n)
        if self._first_dense:
            first = InitCtx(cfg.dtype, alloc, stack=self._first_dense)
            self.dense_layers = nn.ModuleList(
                [DenseLayer(cfg, first) for _ in range(self._first_dense)])
        if cfg.rwkv:
            layers = [RwkvLayer(cfg, stack) for _ in range(cfg.n_layers)]
        elif self._dense:
            layers = [DenseLayer(cfg, stack, use_moe=cfg.n_experts > 0)
                      for _ in range(n)]
        else:
            layers = [MambaLayer(cfg, stack) for _ in range(cfg.n_layers)]
        self.layers = nn.ModuleList(layers)
        if cfg.hybrid_attn_every:
            self.shared_attn = DenseLayer(cfg, ctx)

    # ------------------------------ init ------------------------------ #
    def init(self, seed: int = 0) -> "Model":
        """Fill every parameter by the reference's init rule from a
        ``torch.Generator`` on the model's device seeded with ``seed``."""
        init_params(self, torch.Generator(device=self.device).manual_seed(seed))
        return self

    def shard(self, mesh) -> "Model":
        """Split the model over ``mesh`` where the reference's rules shard
        its weights: over the ``model`` axis
        (``dist.tensor_parallel.shard_model``), then over ``data``
        (``dist.fsdp.shard_data``: the ``embed`` dim).  Each rank keeps its
        block of every cut weight, of a model filled whole (``init`` after
        ``shard`` draws whole tensors too, and ``load_reference_params``
        cuts the reference's).  An axis of one rank, or none, cuts
        nothing.  Returns the model."""
        from repro_torch.dist.fsdp import shard_data
        from repro_torch.dist.tensor_parallel import shard_model
        return shard_data(shard_model(self, mesh), mesh)

    def _gathered(self, module: nn.Module):
        """Context: ``module``'s parameters gathered whole over ``data``
        while it runs (``dist.fsdp.gathered``); as they are where the
        model is not cut over ``data``.  Every loop runs each layer
        under it."""
        return gathered(module, self.fsdp)

    def _whole(self, p: torch.Tensor) -> torch.Tensor:
        """A model-level parameter (the embedding, the head, ``ln_f``, the
        codebook tables) gathered over ``data`` where it is read."""
        return whole(p, self.fsdp)

    def param_axes(self) -> dict[str, tuple]:
        """{the reference's parameter path: logical axes}, the second value
        of the reference's ``Model.init``: stacked leaves once, with their
        leading ``"layers"`` axis (``params.param_axes``)."""
        return param_axes(self)

    # --------------------------- embedding ---------------------------- #
    def embed(self, tokens: torch.Tensor,
              patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """tokens (B, S), or (B, S, CB) with codebooks: the CB streams'
        embeddings summed in stream order.  With the vision stub,
        ``patch_embeds`` (B, n, d) replace the first n positions."""
        with span("repro.embed"):
            cfg = self.cfg
            if cfg.n_codebooks:
                tables = self._whole(self.embed_cb)
                x = self._lookup(tables[0], tokens[..., 0])
                for c in range(1, cfg.n_codebooks):
                    x = x + self._lookup(tables[c], tokens[..., c])
            else:
                x = self._lookup(self._whole(self.embedding), tokens)
            if cfg.vision_stub and patch_embeds is not None:
                n = patch_embeds.shape[1]
                if n > x.shape[1]:
                    raise ValueError(f"{n} patch embeddings do not fit a "
                                     f"sequence of {x.shape[1]} positions")
                x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
            return x

    def _lookup(self, table: torch.Tensor, ids: torch.Tensor):
        """``table[ids]``; with the vocabulary split over ``model``, each
        rank's rows summed over it (``VocabSplit.lookup``)."""
        return table[ids] if self.tp is None else self.tp.lookup(table, ids)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, V), or (B, S, CB, V) with codebooks (one head each); with
        the vocabulary split over ``model``, this rank's columns of V."""
        cfg = self.cfg
        x = rms_norm(x, self._whole(self.ln_f), cfg.norm_eps)
        if self.tp is not None:
            x = self.tp.enter(x)
        if cfg.n_codebooks:     # einsum('bsd,cdv->bscv'), a product a stream
            y = x.flatten(0, 1) @ self._whole(self.head_cb)   # (CB, B*S, V)
            return y.permute(1, 0, 2).unflatten(0, x.shape[:2])
        head = (self._whole(self.embedding).T if cfg.tie_embeddings
                else self._whole(self.head))
        return x @ head

    def _last_logits(self, x: torch.Tensor) -> torch.Tensor:
        """``logits`` of the last position, (B, 1, V) or (B, 1, CB, V),
        whole: gathered over ``model`` where the vocabulary splits."""
        with span("repro.head"):
            lg = self.logits(x[:, -1:])
            return lg if self.tp is None else self.tp.gather(lg)

    def _positions(self, tokens: torch.Tensor, offset: int = 0):
        """(B, S) position ids; (3, B, S) text-like ones under M-RoPE."""
        B, S = tokens.shape[0], tokens.shape[1]
        pos = torch.arange(S, device=tokens.device)[None, :] + offset
        pos = pos.expand(B, S)
        return pos[None].expand(3, B, S) if self.cfg.mrope else pos

    @property
    def _dense(self) -> bool:
        """A dense or MoE stack (neither RWKV6 nor Mamba2)."""
        return not self.cfg.rwkv and self.cfg.family not in ("ssm", "hybrid")

    @property
    def _first_dense(self) -> int:
        """The dense-FFN layers before a MoE stack (DeepSeek's
        ``first_k_dense``; 0 without experts, as in the reference)."""
        cfg = self.cfg
        return cfg.first_k_dense if cfg.n_experts and self._dense else 0

    def _dense_stacks(self) -> list[str]:
        """The dense and MoE families' layer stacks (attribute and cache
        names) in order: ``dense_layers`` first where there is one."""
        return (["dense_layers"] if self._first_dense else []) + ["layers"]

    def attention_layers(self) -> list[DenseLayer]:
        """The layers that hold an attention and an MLP: the dense and MoE
        stacks' layers, or the hybrid's shared block."""
        if self._dense:
            return [layer for name in self._dense_stacks()
                    for layer in getattr(self, name)]
        return [self.shared_attn] if self.cfg.hybrid_attn_every else []

    def _shared_due(self, i: int) -> bool:
        k = self.cfg.hybrid_attn_every
        return bool(k) and (i + 1) % k == 0

    # ----------------------------- forward ----------------------------- #
    def _layer_runner(self, fn):
        """``fn`` as one layer of the training forward: under
        ``cfg.remat``, and while autograd records (grad mode on and a
        parameter that requires grad), recomputed in the backward instead
        of keeping its activations (the reference's ``jax.checkpoint(...,
        nothing_saveable)`` per layer)."""
        if not (self.cfg.remat and torch.is_grad_enabled()
                and any(p.requires_grad for p in self.parameters())):
            return fn
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)

    def forward(self, tokens: torch.Tensor,
                patch_embeds: torch.Tensor | None = None):
        """tokens (B, S) -> (logits (B, S, V), aux): the reference's
        training forward, recorded by autograd where the parameters
        require grad (``train.loop.init_train_state``).  With codebooks
        tokens are (B, S, CB) and logits (B, S, CB, V); ``patch_embeds`` as
        in ``embed``; with the vocabulary split over ``model``, the
        logits are this rank's columns of V.  ``aux`` is the MoE
        load-balance loss summed over the layers in layer order (0.0
        without experts).  Each layer (a
        hybrid's Mamba2 layer with the shared block it is followed by)
        runs under ``_layer_runner``, its parameters gathered over
        ``data`` inside it (``_gathered``)."""
        cfg = self.cfg
        x = self.embed(tokens, patch_embeds)
        positions = self._positions(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self._dense:
            def dense(layer, x):
                with self._gathered(layer):
                    y, _, a = _dense_layer_fwd(layer, x, cfg, positions,
                                               "train")
                return y, a
            run = self._layer_runner(dense)
            for name in self._dense_stacks():
                for layer in getattr(self, name):
                    x, a = run(layer, x)
                    aux = aux + a
            return self.logits(x), aux

        def rwkv(layer, x):
            with self._gathered(layer):
                x = x + rwkv_mod.rwkv6_time_mix(
                    layer.time, rms_norm(x, layer.ln1, cfg.norm_eps), cfg)
                return x + rwkv_mod.rwkv6_channel_mix(
                    layer.time, rms_norm(x, layer.ln2, cfg.norm_eps), cfg)

        def mamba(layer, x, shared: bool):
            with self._gathered(layer):
                x = x + ssm_mod.mamba2_forward(
                    layer.mixer, rms_norm(x, layer.ln, cfg.norm_eps), cfg)
            if shared:
                with self._gathered(self.shared_attn):
                    x, _, _ = _dense_layer_fwd(self.shared_attn, x, cfg,
                                               positions, "train")
            return x

        run = self._layer_runner(rwkv if cfg.rwkv else mamba)
        for i, layer in enumerate(self.layers):
            x = run(layer, x) if cfg.rwkv else run(layer, x,
                                                   self._shared_due(i))
        return self.logits(x), aux

    # ------------------------------ cache ------------------------------ #
    def init_cache(self, batch: int, max_len: int, *, whole: bool = False,
                   device=None) -> dict:
        """Per-layer decoding state, stacked along a leading layers axis:
        ``layers`` {ssm (n, B, H, P, N) f32, conv (n, B, K-1, conv_dim)}
        and, for the hybrid, ``shared_attn`` {k, v (n_attn, B, L, Hkv, hd),
        len (n_attn, 1) int32}, one KV cache per application of the shared
        block.  For RWKV6, ``layers`` {wkv (n, B, H, K, K) f32, shift_t and
        shift_c (n, B, d)}, whatever ``max_len``.  For the dense and MoE
        stacks, ``layers`` {k, v (n, B, L, Hkv, hd), len (n, 1) int32}, L
        ``max_len`` or, with a sliding window, the smaller of it and the
        window (a ring); with MLA {ckv (n, B, L, kv_lora), krope (n, B, L,
        dr), len}; with a ``first_k_dense`` stack, ``dense_layers`` the same
        for its layers and ``layers`` for the MoE layers.

        Split over ``model``, the rank keeps its share of the heads (kv
        heads, ssm heads and the conv channels, WKV heads) that its
        weights keep; with ``whole``, the unsplit model's sizes.
        ``device``: default the model's."""
        with span("repro.init_cache"):
            cfg = self.cfg
            dev = self.device if device is None else device

            def size(p, dim):      # the rank's share of a dim, or the whole
                return whole_shape(p)[dim] if whole else p.shape[dim]
            if cfg.rwkv:
                return {"layers": rwkv_mod.rwkv6_state_init(
                    cfg, batch, device=dev, n=cfg.n_layers,
                    heads=size(self.layers[0].time.u, 0))}
            if self._dense:
                if cfg.attn_type == "mla":
                    return {name: attn.mla_cache_init(
                                cfg, batch, max_len, device=dev,
                                n=len(getattr(self, name)))
                            for name in self._dense_stacks()}
                # the kv heads a rank keeps: wk's, a share where they split
                return {name: attn.gqa_cache_init(
                            cfg, batch, max_len, device=dev,
                            n=len(getattr(self, name)),
                            n_kv_heads=size(getattr(self, name)[0].attn.wk, 1))
                        for name in self._dense_stacks()}
            mixer = self.layers[0].mixer
            cache = {"layers": ssm_mod.mamba2_state_init(
                cfg, batch, device=dev, n=cfg.n_layers,
                heads=size(mixer.norm_w, 0) // cfg.ssm_head_dim,
                conv_dim=size(mixer.conv_b, 0))}
            if cfg.hybrid_attn_every:
                cache["shared_attn"] = attn.gqa_cache_init(
                    cfg, batch, max_len, device=dev,
                    n=cfg.n_layers // cfg.hybrid_attn_every,
                    n_kv_heads=size(self.shared_attn.attn.wk, 1))
            return cache

    def cache_axes(self) -> dict[str, tuple]:
        """{cache path: logical axes} of every leaf ``init_cache`` makes,
        the second value of the reference's ``Model.init_cache``: each
        leaf's axes behind the leading ``"layers"`` axis of its stack."""
        cfg = self.cfg
        if cfg.rwkv:
            stacks = {"layers": rwkv_mod.RWKV6_STATE_AXES}
        elif self._dense:
            one = (attn.MLA_CACHE_AXES if cfg.attn_type == "mla"
                   else attn.GQA_CACHE_AXES)
            stacks = {name: one for name in self._dense_stacks()}
        else:
            stacks = {"layers": ssm_mod.MAMBA2_STATE_AXES}
            if cfg.hybrid_attn_every:
                stacks["shared_attn"] = attn.GQA_CACHE_AXES
        return {f"{name}.{leaf}": ("layers",) + axes
                for name, leaves in stacks.items()
                for leaf, axes in leaves.items()}

    def _rwkv_stack(self, x: torch.Tensor, layers: dict, carry: bool
                    ) -> torch.Tensor:
        """The RWKV6 layers, each writing its WKV and token-shift states
        into the stacked ``layers`` cache in place; with ``carry`` each
        starts from the states there (decode), else from zeros
        (prefill)."""
        cfg = self.cfg
        for i, layer in enumerate(self.layers):
            with self._gathered(layer):
                h, wkv, sh_t = rwkv_mod.rwkv6_time_mix(
                    layer.time, rms_norm(x, layer.ln1, cfg.norm_eps), cfg,
                    shift_state=layers["shift_t"][i] if carry else None,
                    wkv_state=layers["wkv"][i] if carry else None,
                    return_state=True)
                x = x + h
                h, sh_c = rwkv_mod.rwkv6_channel_mix(
                    layer.time, rms_norm(x, layer.ln2, cfg.norm_eps), cfg,
                    shift_state=layers["shift_c"][i] if carry else None,
                    return_state=True)
                x = x + h
            for key, new in (("wkv", wkv), ("shift_t", sh_t),
                             ("shift_c", sh_c)):
                layers[key][i].copy_(new)
        return x

    # ----------------------------- prefill ----------------------------- #
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict,
                patch_embeds: torch.Tensor | None = None):
        """Full-sequence forward that also fills the decode cache (in
        place).  Returns (last-position logits (B, 1, V), or (B, 1, CB, V)
        with codebooks, cache); tokens and ``patch_embeds`` as in
        ``forward``.  An RWKV6 prefill starts from zero shift and WKV
        states whatever the cache holds, as the reference's does."""
        with span("repro.prefill"):
            cfg = self.cfg
            x = self.embed(tokens, patch_embeds)
            positions = self._positions(tokens)
            layers = cache["layers"]
            if cfg.rwkv:
                x = self._rwkv_stack(x, layers, carry=False)
                return self._last_logits(x), cache
            if self._dense:
                for name in self._dense_stacks():
                    for i, layer in enumerate(getattr(self, name)):
                        with self._gathered(layer):
                            x, _, _ = _dense_layer_fwd(
                                layer, x, cfg, positions, "prefill",
                                _at(cache[name], i))
                return self._last_logits(x), cache
            attn_idx = 0
            for i, layer in enumerate(self.layers):
                with self._gathered(layer):
                    h, ssm_state, conv_state = ssm_mod.mamba2_forward(
                        layer.mixer, rms_norm(x, layer.ln, cfg.norm_eps), cfg,
                        return_state=True)
                x = x + h
                layers["ssm"][i].copy_(ssm_state)
                layers["conv"][i].copy_(conv_state)
                if self._shared_due(i):
                    with self._gathered(self.shared_attn):
                        x, _, _ = _dense_layer_fwd(
                            self.shared_attn, x, cfg, positions, "prefill",
                            _at(cache["shared_attn"], attn_idx))
                    attn_idx += 1
            return self._last_logits(x), cache

    # ------------------------------ decode ----------------------------- #
    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: dict):
        """Single-token decode step.  tokens: (B, 1), or (B, 1, CB) with
        codebooks.  Returns (logits (B, 1, V) or (B, 1, CB, V), cache), the
        cache updated in place."""
        with span("repro.decode"):
            cfg = self.cfg
            x = self.embed(tokens)
            layers = cache["layers"]
            if cfg.rwkv:
                x = self._rwkv_stack(x, layers, carry=True)
                return self._last_logits(x), cache
            positions = None
            attn_cache = (cache.get("dense_layers", layers) if self._dense
                          else cache.get("shared_attn"))
            if attn_cache is not None:
                # a copy: the first attention layer bumps len in place
                pos = attn_cache["len"][0, 0].clone()
                positions = pos.reshape(1, 1).expand(x.shape[0], 1)
                if cfg.mrope:
                    positions = positions[None].expand(3, x.shape[0], 1)
            if self._dense:
                for name in self._dense_stacks():
                    for i, layer in enumerate(getattr(self, name)):
                        with self._gathered(layer):
                            x, _, _ = _dense_layer_fwd(
                                layer, x, cfg, positions, "decode",
                                _at(cache[name], i))
                return self._last_logits(x), cache
            attn_idx = 0
            for i, layer in enumerate(self.layers):
                with self._gathered(layer):
                    h, ssm_state, conv_state = ssm_mod.mamba2_decode(
                        layer.mixer, rms_norm(x, layer.ln, cfg.norm_eps), cfg,
                        layers["ssm"][i], layers["conv"][i])
                x = x + h
                layers["ssm"][i].copy_(ssm_state)
                layers["conv"][i].copy_(conv_state)
                if self._shared_due(i):
                    with self._gathered(self.shared_attn):
                        x, _, _ = _dense_layer_fwd(
                            self.shared_attn, x, cfg, positions, "decode",
                            _at(cache["shared_attn"], attn_idx))
                    attn_idx += 1
            return self._last_logits(x), cache


def build_model(cfg: ModelConfig, device=None, *, seed: int | None = 0,
                mesh=None) -> Model:
    """A model on ``device``, filled from ``seed`` (None: left
    uninitialised, for ``load_reference_params``); with ``mesh``, split
    over its ``model`` axis and cut over its ``data`` axis
    (``Model.shard``) and filled after, as whole.  A split model is made
    on the meta device and cut there, so that a rank never holds the whole
    model's parameters, only its blocks."""
    if mesh is None:
        model = Model(cfg, device)
    else:
        model = Model(cfg, device, on_meta=True).shard(mesh)
        materialize(model, model.device)
    return model if seed is None else model.init(seed)


# ===================================================================== #
# losses (``repro.models.model.cross_entropy`` / ``loss_fn``)
# ===================================================================== #
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE.  logits: (B, S, V) or (B, S, CB, V); labels
    match without V.  In float32: logsumexp minus the gold logit."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def loss_fn(model: Model, batch: dict) -> tuple[torch.Tensor, dict]:
    """(CE of position t's logits against label t + 1, plus 0.01 x the MoE
    aux loss; {"ce", "aux"}); with the vocabulary split over ``model``,
    the vocab-parallel CE of the rank's logit columns.  ``batch``:
    ``tokens``, ``labels`` (shaped like the tokens: (B, S), or (B, S, CB)
    with codebooks) and, for the vision stub, ``patch_embeds``."""
    logits, aux = model(batch["tokens"], batch.get("patch_embeds"))
    ce = cross_entropy if model.tp is None else model.tp.cross_entropy
    loss = ce(logits[:, :-1], batch["labels"][:, 1:])
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}
