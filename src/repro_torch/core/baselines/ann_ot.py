"""ANN+OT: neural-network throughput prediction over historical logs plus
online tuning (Nine, Guner & Kosar, NDM'15 [44]).

A small MLP (plain torch, trained with a hand-written Adam through
``torch.autograd.grad``) learns
th = g(bw, rtt, avg_file, n_files, cc, p, pp) from the history.  At transfer
time the model's grid argmax seeds the first sample; online tuning then
rescales predictions by the observed/predicted ratio and re-optimizes — the
paper's critique being that it "always tends to choose the maxima from
historical log rather than the global one".

The network trains and predicts on ``device`` (None: the CUDA card, see
``device.resolve_device``) in the dtype of its parameters, float32 unless
float64 ones are given.  The JAX package draws its initial parameters from
``jax.random.PRNGKey(seed)``, a stream torch cannot reproduce; the port
draws its own from a ``torch.Generator`` seeded with ``seed``, and
``annot_params_from_reference`` carries the reference's over where the two
must start alike.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.baselines.common import BaseTuner
from repro_torch.device import resolve_device
from repro_torch.netsim.environment import Environment, ParamBounds, TransferParams
from repro_torch.netsim.loggen import LogEntry
from repro_torch.netsim.workload import Dataset

SIZES = (8, 64, 64, 1)          # features -> two hidden layers -> throughput

MLPParams = list[tuple[torch.Tensor, torch.Tensor]]


def _feats(bw, rtt, avg_mb, n_files, cc, p, pp):
    return np.stack([
        np.log10(bw) / 4.0, np.log10(np.maximum(rtt, 1e-5)) / 3.0,
        np.log10(np.maximum(avg_mb, 1e-2)) / 4.0,
        np.log10(np.maximum(n_files, 1)) / 4.0,
        cc / 16.0, p / 16.0, pp / 16.0,
        (cc * p) / 256.0,
    ], axis=-1).astype(np.float32)


def init_mlp(generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32) -> MLPParams:
    """He-normal weights, N(0, 1) * sqrt(2 / fan_in), and zero biases, on
    the generator's device (the reference's ``_init_mlp`` rule)."""
    params = []
    for m, n in zip(SIZES[:-1], SIZES[1:]):
        W = torch.randn((m, n), generator=generator, dtype=dtype,
                        device=generator.device) * math.sqrt(2.0 / m)
        params.append((W, torch.zeros((n,), dtype=dtype,
                                      device=generator.device)))
    return params


def annot_params_from_reference(params) -> MLPParams:
    """The JAX package's ``[(W, b), ...]``, as numpy arrays, as the port's
    parameters: CPU tensors of the same dtype and values (copies)."""
    return [(torch.from_numpy(np.array(W)), torch.from_numpy(np.array(b)))
            for W, b in params]


def _mlp(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    for i, (W, b) in enumerate(params):
        x = x @ W + b
        if i < len(params) - 1:
            x = torch.relu(x)
    return x[..., 0]


def _loss(params: MLPParams, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    pred = _mlp(params, X)
    return torch.mean((pred - y) ** 2)


def _pairs(flat: list[torch.Tensor]) -> MLPParams:
    return list(zip(flat[0::2], flat[1::2]))


def _train(params: MLPParams, X: torch.Tensor, y: torch.Tensor, epochs: int,
           lr=1e-3, b1=0.9, b2=0.999, eps=1e-8) -> MLPParams:
    """``epochs`` full-batch Adam steps on the mean squared error, with the
    reference's constants, bias correction and ``eps`` placement."""
    flat = [p.detach().clone().requires_grad_(True)
            for pair in params for p in pair]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    for t in range(1, epochs + 1):
        g = torch.autograd.grad(_loss(_pairs(flat), X, y), flat)
        with torch.no_grad():
            for i, (p_, gi) in enumerate(zip(flat, g)):
                m[i] = b1 * m[i] + (1 - b1) * gi
                v[i] = b2 * v[i] + (1 - b2) * gi * gi
                mh = m[i] / (1 - b1 ** t)
                vh = v[i] / (1 - b2 ** t)
                flat[i] = p_ - lr * mh / (torch.sqrt(vh) + eps)
        flat = [p.requires_grad_(True) for p in flat]
    return _pairs([p.detach() for p in flat])


class ANNOT(BaseTuner):
    name = "ANN+OT"

    def __init__(self, history: list[LogEntry],
                 bounds: ParamBounds = ParamBounds(), *,
                 epochs: int = 300, seed: int = 0, device=None,
                 params: MLPParams | None = None):
        """``params``: initial parameters (e.g. from
        ``annot_params_from_reference``), copied to ``device``; their dtype
        sets the network's.  None: drawn by ``init_mlp`` in float32 from a
        generator on ``device`` seeded with ``seed``."""
        super().__init__(bounds)
        self.device = resolve_device(device)
        X = _feats(
            np.array([e.bandwidth_mbps for e in history]),
            np.array([e.rtt_s for e in history]),
            np.array([e.avg_file_mb for e in history]),
            np.array([e.n_files for e in history]),
            np.array([e.cc for e in history], np.float64),
            np.array([e.p for e in history], np.float64),
            np.array([e.pp for e in history], np.float64))
        y = np.array([e.throughput_mbps for e in history], np.float32)
        self._yscale = float(max(y.max(), 1.0))
        y = y / self._yscale
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_mlp(gen)
        params = [(W.to(self.device), b.to(self.device)) for W, b in params]
        self.dtype = params[0][0].dtype
        # the features are float32, as the reference's; a float64 network
        # takes them cast (torch's matmul refuses mixed dtypes, where JAX
        # promotes)
        Xt = torch.from_numpy(X).to(self.device, self.dtype)
        yt = torch.from_numpy(y).to(self.device, self.dtype)
        self.params = _train(params, Xt, yt, epochs)
        with torch.no_grad():
            self.train_mse = float(_loss(self.params, Xt, yt))
        self._scale = 1.0       # online-tuning rescale factor
        self._grid_cache: TransferParams | None = None

    # ------------------------------------------------------------------ #
    def _grid_argmax(self, env: Environment, dataset: Dataset) -> TransferParams:
        b = self.bounds
        combos = np.array([[cc, p, pp]
                           for cc in range(1, b.max_cc + 1)
                           for p in range(1, b.max_p + 1)
                           for pp in range(1, b.max_pp + 1)], np.float64)
        X = _feats(np.full(len(combos), env.link.bandwidth_mbps),
                   np.full(len(combos), env.link.rtt_s),
                   np.full(len(combos), dataset.avg_file_mb),
                   np.full(len(combos), dataset.n_files),
                   combos[:, 0], combos[:, 1], combos[:, 2])
        with torch.no_grad():
            pred = _mlp(self.params,
                        torch.from_numpy(X).to(self.device, self.dtype))
            k = int(torch.argmax(pred))       # the first index on ties
            self._best_pred = float(pred[k]) * self._yscale
        return TransferParams(int(combos[k, 0]), int(combos[k, 1]),
                              int(combos[k, 2]))

    @property
    def n_probe_chunks(self) -> int:
        return 1

    def start(self, env: Environment, dataset: Dataset) -> TransferParams:
        self._scale = 1.0
        self._env, self._dataset = env, dataset
        self._grid_cache = self._grid_argmax(env, dataset)
        return self._grid_cache

    def observe(self, params: TransferParams, achieved: float,
                chunk_idx: int) -> TransferParams:
        # online tuning: rescale the learned surface by observed/predicted
        # and nudge concurrency against the residual
        if self._best_pred > 1e-6:
            self._scale = achieved / self._best_pred
        if self._scale < 0.7 and chunk_idx == 0:
            # heavier load than history: back off total streams
            cc = max(1, int(params.cc * max(self._scale, 0.4)))
            return TransferParams(cc, params.p, params.pp)
        return params
