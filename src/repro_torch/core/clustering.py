"""Clustering of historical logs (Sec. 3.1, Eqs. 2-5), small-n and at scale.

Implements both algorithms the paper evaluates:
  * K-means++ seeding + Lloyd iterations (O(log m)-competitive seeding),
  * HAC with UPGMA linkage over centroid distance (Eq. 2),
with the Calinski-Harabasz index (Eq. 3) for model-order selection.

Two compute paths share the ``ClusterModel`` contract:
  * the original pure-numpy path (exact Lloyd / HAC), retained as the
    small-n oracle and the default below ``BATCHED_THRESHOLD`` rows;
  * a batched torch path for million-entry logs, run on ``device``:
    mini-batch k-means++ (Sculley 2010) trained for *every* candidate model
    order in ``m_range`` simultaneously — one sweep over shared mini-batches
    with the centroid tensors stacked over an m axis — followed by a few
    exact full-batch Lloyd refinement steps and a final full-data label
    pass, per order through the nearest-centroid kernel
    (``kernels.ops.cluster_assign``; CUDA on the card) under ``use_kernel``.
    CH model-order selection then scores all candidate orders from
    per-cluster sufficient statistics of that label pass.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device, resolve_use_kernel

# n at/above which fit_clusters routes "kmeans++" to the batched torch path.
BATCHED_THRESHOLD = 4096

# Full-data passes process points in fixed-size chunks so live temporaries
# stay bounded regardless of n (shared by the batched sweeps and assign_many).
_CHUNK = 65536


def kmeans_pp_init(X: np.ndarray, m: int, rng: np.random.Generator) -> np.ndarray:
    """K-means++ seeding (Arthur & Vassilvitskii 2007)."""
    n = X.shape[0]
    centers = [X[rng.integers(n)]]
    for _ in range(1, m):
        d2 = np.min(((X[:, None, :] - np.asarray(centers)[None]) ** 2).sum(-1), axis=1)
        total = d2.sum()
        if not np.isfinite(total) or total <= 1e-12:
            # degenerate data (all points coincide): uniform seeding
            centers.append(X[rng.integers(n)])
            continue
        centers.append(X[rng.choice(n, p=d2 / total)])
    return np.asarray(centers)


def kmeans(X: np.ndarray, m: int, *, iters: int = 50, seed: int = 0,
           init: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """K-means++ clustering -> (labels (n,), centroids (m, d)).

    ``init`` overrides the k-means++ seeding with explicit starting
    centroids — the batched path's fixed-point fidelity check polishes its
    result with these exact Lloyd iterations.
    """
    rng = np.random.default_rng(seed)
    C = kmeans_pp_init(X, m, rng) if init is None else np.array(init, np.float64)
    labels = np.zeros(X.shape[0], np.int64)
    for _ in range(iters):
        d2 = ((X[:, None, :] - C[None]) ** 2).sum(-1)
        new = d2.argmin(1)
        if np.array_equal(new, labels) and _ > 0:
            break
        labels = new
        for k in range(m):
            mask = labels == k
            if mask.any():
                C[k] = X[mask].mean(0)
    return labels, C


def hac_upgma(X: np.ndarray, m: int) -> np.ndarray:
    """Agglomerative clustering, UPGMA update, centroid distance (Eq. 2).

    Merges the closest cluster pair until ``m`` clusters remain; the proximity
    matrix row/column of the merged pair is refreshed with the new centroid.
    """
    n = X.shape[0]
    active = list(range(n))
    centroid = {i: X[i].copy() for i in range(n)}
    size = {i: 1 for i in range(n)}
    members: dict[int, list[int]] = {i: [i] for i in range(n)}
    # proximity matrix over active clusters
    D = np.full((n, n), np.inf)
    for i in range(n):
        d = np.sqrt(((X - X[i]) ** 2).sum(-1))
        D[i] = d
        D[i, i] = np.inf
    nxt = n
    while len(active) > m:
        sub = np.ix_(active, active)
        flat = D[sub]
        a_idx, b_idx = np.unravel_index(np.argmin(flat), flat.shape)
        a, b = active[a_idx], active[b_idx]
        # UPGMA: new centroid is the size-weighted mean of the merged pair.
        ca = (size[a] * centroid[a] + size[b] * centroid[b]) / (size[a] + size[b])
        centroid[nxt] = ca
        size[nxt] = size[a] + size[b]
        members[nxt] = members[a] + members[b]
        active.remove(a)
        active.remove(b)
        if nxt >= D.shape[0]:
            D = np.pad(D, ((0, n), (0, n)), constant_values=np.inf)
        for o in active:
            D[nxt, o] = D[o, nxt] = np.sqrt(((ca - centroid[o]) ** 2).sum())
        D[nxt, nxt] = np.inf
        active.append(nxt)
        nxt += 1
    labels = np.zeros(n, np.int64)
    for k, cid in enumerate(active):
        labels[members[cid]] = k
    return labels


def ch_index(X: np.ndarray, labels: np.ndarray) -> float:
    """Calinski-Harabasz index (Eq. 3): between/within variance ratio."""
    n = X.shape[0]
    ks = np.unique(labels)
    m = len(ks)
    if m < 2 or m >= n:
        return -np.inf
    overall = X.mean(0)
    between = 0.0
    within = 0.0
    for k in ks:
        pts = X[labels == k]
        c = pts.mean(0)
        between += len(pts) * ((c - overall) ** 2).sum()
        within += ((pts - c) ** 2).sum()
    if within <= 1e-12:
        return np.inf
    return float((between / (m - 1)) / (within / (n - m)))


def label_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of points two labelings agree on, up to cluster permutation.

    Solves the optimal one-to-one cluster matching over the confusion matrix
    (Hungarian algorithm), so relabelings of the same partition score 1.0.
    Used by the scale benchmark and the batched-vs-numpy parity tests.
    """
    from scipy.optimize import linear_sum_assignment
    a = np.asarray(a, np.int64).ravel()
    b = np.asarray(b, np.int64).ravel()
    if a.size != b.size or a.size == 0:
        raise ValueError("labelings must be the same non-zero length")
    conf = np.zeros((int(a.max()) + 1, int(b.max()) + 1))
    np.add.at(conf, (a, b), 1.0)
    ri, ci = linear_sum_assignment(-conf)
    return float(conf[ri, ci].sum() / a.size)


@dataclasses.dataclass
class ClusterModel:
    labels: np.ndarray
    centroids: np.ndarray
    m: int
    method: str
    ch: float
    # Per-centroid point counts (Sculley 2010 learning-rate state).  Fit
    # paths persist the final-labeling counts so streaming ``partial_fit``
    # updates continue the mini-batch schedule the offline fit would have
    # used; None on models built before this field existed (older pickles,
    # hand-built models) — ``_ensure_counts`` rebuilds from labels then.
    counts: np.ndarray | None = None

    def assign(self, x: np.ndarray) -> int:
        """Nearest-centroid assignment for a new feature vector."""
        return int(((self.centroids - x[None]) ** 2).sum(-1).argmin())

    def assign_many(self, X: np.ndarray, *, use_kernel: bool = False,
                    device=None) -> np.ndarray:
        """Nearest-centroid assignment for many feature vectors at once.

        The default path is chunked float64 numpy — arithmetic-identical to
        :meth:`assign`, so how an entry is routed can never depend on how
        large a batch it arrived in (the refresh subsystem's determinism
        guarantee).  ``use_kernel=True`` routes through the float32
        nearest-centroid kernel on ``device`` instead (the CUDA kernel on
        the card, its plain-torch version on the CPU).
        """
        if use_kernel:
            from repro_torch.kernels import ops
            dev = resolve_device(device)
            Xf = np.ascontiguousarray(np.atleast_2d(X), np.float32)
            Cf = np.ascontiguousarray(self.centroids, np.float32)
            lab, _ = ops.cluster_assign(torch.from_numpy(Xf).to(dev),
                                        torch.from_numpy(Cf).to(dev))
            return lab.cpu().numpy().astype(np.int64)
        X = np.atleast_2d(np.asarray(X, np.float64))
        out = np.empty(X.shape[0], np.int64)
        for i in range(0, X.shape[0], _CHUNK):
            blk = X[i:i + _CHUNK]
            d2 = ((self.centroids[None] - blk[:, None, :]) ** 2).sum(-1)
            out[i:i + _CHUNK] = d2.argmin(1)
        return out

    def _ensure_counts(self) -> np.ndarray:
        """Per-centroid counts, rebuilt from the fit labels when absent."""
        if self.counts is None:
            if self.labels is not None and self.labels.size:
                self.counts = np.bincount(
                    np.asarray(self.labels, np.int64),
                    minlength=self.m).astype(np.float64)
            else:
                self.counts = np.ones(self.m, np.float64)
        return self.counts

    def partial_fit(self, X: np.ndarray, *, use_kernel: bool = False,
                    device=None) -> np.ndarray:
        """Fold a mini-batch of new points into the centroids in place.

        One Sculley (2010) mini-batch k-means step, the numpy twin of the
        ``_minibatch_sweep`` arithmetic: assign the batch to the current
        centroids, then move each winning centroid toward its batch mean
        with the cumulative 1/counts learning rate.  Assignment goes through
        :meth:`assign_many`, so by default routing is arithmetic-identical
        to the scalar query path regardless of batch size.  Returns the batch
        labels so callers can reuse them (e.g. ``OfflineDB.update``'s
        ``assignments=``) without a second assignment pass.
        """
        X = np.atleast_2d(np.asarray(X, np.float64))
        labels = self.assign_many(X, use_kernel=use_kernel, device=device)
        counts = self._ensure_counts()
        cnt = np.bincount(labels, minlength=self.m).astype(np.float64)
        sums = np.zeros_like(self.centroids, np.float64)
        np.add.at(sums, labels, X)
        counts += cnt
        lr = np.where(cnt > 0, cnt / np.maximum(counts, 1.0), 0.0)
        tgt = sums / np.maximum(cnt, 1.0)[:, None]
        self.centroids += lr[:, None] * (tgt - self.centroids)
        return labels


# --------------------------------------------------------------------- #
# batched path: mini-batch k-means++ over the whole m_range in one sweep
# --------------------------------------------------------------------- #
# Unused (padded) centroid slots carry this coordinate value: their squared
# distance to any real point is ~1e12, so they can never win an argmin, and
# winning nothing means they are never updated — no masking tensors needed.
_SENTINEL = 1.0e6


def _assign_stacked(xc: torch.Tensor, Cf: torch.Tensor, K: int, M: int
                    ) -> torch.Tensor:
    """(CH, d) points vs (K*M, d) stacked centroids -> (CH, K) labels.

    The flattened twin of ``kernels.ref.cluster_assign_ref``: one
    (CH, d) x (d, K*M) matmul scores every model order's centroids at
    once; sentinel slots lose every argmin, so labels stay in [0, m).
    """
    x2 = (xc * xc).sum(-1)[:, None]
    c2 = (Cf * Cf).sum(-1)[None, :]
    d2 = (x2 - 2.0 * (xc @ Cf.T) + c2).reshape(-1, K, M)
    return torch.argmin(d2, dim=-1)


def _minibatch_sweep(X: torch.Tensor, C0: torch.Tensor,
                     batches: torch.Tensor) -> torch.Tensor:
    """Mini-batch k-means for all model orders at once.

    X: (n, d); C0: (K, M, d) seeded centroids, sentinel-padded past each
    order's m; batches: (T, B) point indices shared by every order.  One
    step assigns a mini-batch under every order simultaneously and moves
    each winning centroid toward its batch mean with the 1/counts learning
    rate (Sculley 2010).  Centroids that win no points keep their previous
    position.  The per-cluster sums are a one-hot matmul, not a scatter:
    float atomics on CUDA would change the summation order run to run.
    """
    K, M, d = C0.shape
    slots = torch.arange(M, device=X.device)
    C = C0
    counts = torch.zeros((K, M), dtype=torch.float32, device=X.device)
    for idx in batches:
        xb = X[idx]                                           # (B, d)
        lab = _assign_stacked(xb, C.reshape(K * M, d), K, M)  # (B, K)
        oh = (lab[..., None] == slots).to(torch.float32)      # (B, K, M)
        cnt = oh.sum(0)                                       # (K, M)
        sums = torch.einsum("bkm,bd->kmd", oh, xb)
        counts = counts + cnt
        lr = torch.where(cnt > 0, cnt / torch.clamp(counts, min=1.0), 0.0)
        tgt = sums / torch.clamp(cnt, min=1.0)[..., None]
        C = C + lr[..., None] * (tgt - C)
    return C


def _refine_and_stats(Xc: torch.Tensor, wc: torch.Tensor, C0: torch.Tensor,
                      refine_iters: int):
    """Exact Lloyd refinement + final labels/statistics, all orders.

    Xc: (nc, CH, d) chunked zero-padded points; wc: (nc, CH) 1.0 for real
    rows; ``refine_iters`` full-batch Lloyd steps.  Returns the refined
    centroids, the final full-data labels (n_pad, K), and the per-(order,
    cluster) point counts and coordinate sums of that final labeling — the
    sufficient statistics the CH model-order selection needs, so scoring
    every candidate m costs no extra pass over the data.  Empty clusters
    keep stale centroids.
    """
    K, M, d = C0.shape
    slots = torch.arange(M, device=Xc.device)

    def data_pass(C, want_labels):
        Cf = C.reshape(K * M, d)
        sums = torch.zeros((K, M, d), dtype=torch.float32, device=Xc.device)
        cnt = torch.zeros((K, M), dtype=torch.float32, device=Xc.device)
        labs = []
        for xc, wv in zip(Xc, wc):                            # (CH, d), (CH,)
            lab = _assign_stacked(xc, Cf, K, M)               # (CH, K)
            oh = ((lab[..., None] == slots).to(torch.float32)
                  * wv[:, None, None])
            sums = sums + torch.einsum("bkm,bd->kmd", oh, xc)
            cnt = cnt + oh.sum(0)
            if want_labels:
                labs.append(lab.to(torch.int32))
        return sums, cnt, labs

    C = C0
    for _ in range(max(refine_iters, 0)):
        sums, cnt, _ = data_pass(C, False)
        new = sums / torch.clamp(cnt, min=1.0)[..., None]
        C = torch.where(cnt[..., None] > 0, new, C)
    sums, cnt, labs = data_pass(C, True)
    return C, sums, cnt, torch.cat(labs).reshape(-1, K)


def _ch_from_labels(X: np.ndarray, labels: np.ndarray, m: int
                    ) -> tuple[float, np.ndarray, np.ndarray]:
    """CH index + exact centroids + counts from one label pass.

    Per-cluster counts / coordinate sums come from ``np.bincount`` (O(n d)),
    so scoring every candidate order costs one pass over the labels instead
    of a fresh O(n m d) distance computation.
    """
    n, d = X.shape
    cnt = np.bincount(labels, minlength=m).astype(np.float64)
    sums = np.stack([np.bincount(labels, weights=X[:, j], minlength=m)
                     for j in range(d)], axis=1)              # (m, d)
    score, cents = _ch_from_stats(n, float((X * X).sum()), X.mean(0),
                                  cnt, sums)
    return score, cents, cnt


def _ch_from_stats(n: int, sq_total: float, overall: np.ndarray,
                   cnt: np.ndarray, sums: np.ndarray) -> tuple[float, np.ndarray]:
    """CH index + exact centroids from per-cluster sufficient statistics.

    ``within = sum |x|^2 - sum_k n_k |c_k|^2`` when ``c_k`` is the exact
    assignment mean, so one (cnt, sums) pair scores a candidate order in
    O(m d) — no extra pass over the data.
    """
    cents = sums / np.maximum(cnt, 1.0)[:, None]
    occ = cnt > 0
    m_eff = int(occ.sum())
    if m_eff < 2 or m_eff >= n:
        return -np.inf, cents
    within = max(sq_total - float((cnt[occ] * (cents[occ] ** 2).sum(-1)).sum()),
                 0.0)
    between = float((cnt[occ] * ((cents[occ] - overall[None]) ** 2).sum(-1)
                     ).sum())
    if within <= 1e-12 * max(sq_total, 1.0):
        return np.inf, cents
    return float((between / (m_eff - 1)) / (within / (n - m_eff))), cents


def fit_clusters_batched(X: np.ndarray, *, m_range: range | None = None,
                         seed: int = 0, batch_size: int = 2048,
                         minibatch_iters: int = 80, refine_iters: int = 5,
                         init_subsample: int = 8192,
                         use_kernel: bool | None = None,
                         device=None) -> ClusterModel:
    """Batched clustering with CH model-order selection, for large logs.

    Every candidate order in ``m_range`` is seeded with k-means++ on a
    shared subsample, trained together through one mini-batch sweep (the
    centroid tensors are stacked over an m axis), polished with a few exact
    full-batch Lloyd steps, and labeled in one final full-data pass that
    also emits every order's per-cluster sufficient statistics — the CH
    index then scores the whole ``m_range`` without touching the data
    again.  Largest CH wins, first such order on ties (the numpy path's
    selection rule).  The sweeps run in float32 on ``device``; the seeding
    and the mini-batch indices come from ``np.random.default_rng(seed)`` on
    the host, exactly as in the JAX package.  ``use_kernel`` (None: True on
    CUDA) routes the final label pass through the nearest-centroid kernel
    once per order instead of the fused sweep's labels.
    """
    device = resolve_device(device)
    use_kernel = resolve_use_kernel(use_kernel, device)
    X = np.ascontiguousarray(np.asarray(X, np.float64))
    n, d = X.shape
    if m_range is None:
        m_range = range(2, min(9, max(3, n // 8)))
    ms = [int(m) for m in m_range if 2 <= m < n]
    if n < 3 or not ms:
        raise ValueError(
            f"cannot cluster {n} points over m_range={list(m_range)!r}: "
            "need at least 3 points and one order with 2 <= m < n")
    rng = np.random.default_rng(seed)
    sub = (X if n <= init_subsample
           else X[rng.choice(n, init_subsample, replace=False)])
    K, M = len(ms), max(ms)
    C0 = np.full((K, M, d), _SENTINEL)
    for i, m in enumerate(ms):
        C0[i, :m] = kmeans_pp_init(sub, m, rng)
    B = min(batch_size, n)
    batches = rng.integers(0, n, size=(minibatch_iters, B))

    # Full float32 in every product: TF32 (off by default today) would round
    # the cross term ``xc @ Cf.T`` to ~3 digits and flip labels.
    torch.backends.cuda.matmul.allow_tf32 = False
    Xf = torch.as_tensor(X, dtype=torch.float32, device=device)
    C = _minibatch_sweep(Xf, torch.as_tensor(C0, dtype=torch.float32,
                                             device=device),
                         torch.as_tensor(batches, device=device))
    pad = (-n) % _CHUNK if n >= _CHUNK else 0
    w = torch.ones(n + pad, dtype=torch.float32, device=device)
    if pad:
        Xp = torch.cat([Xf, Xf.new_zeros((pad, d))])
        w[n:] = 0.0
    else:
        Xp = Xf
    nc = max((n + pad) // _CHUNK, 1)
    C, sums, cnt, labs = _refine_and_stats(
        Xp.reshape(nc, -1, d), w.reshape(nc, -1), C, refine_iters)
    C = C.cpu().numpy().astype(np.float64)
    sums = sums.cpu().numpy().astype(np.float64)
    cnt = cnt.cpu().numpy().astype(np.float64)

    sq_total = float((X * X).sum())
    overall = X.mean(0)
    best: ClusterModel | None = None
    best_i = -1
    for i, m in enumerate(ms):
        if use_kernel:
            from repro_torch.kernels import ops
            lab, _ = ops.cluster_assign(
                Xf, torch.as_tensor(C[i, :m], dtype=torch.float32,
                                    device=device))
            lab = lab.cpu().numpy().astype(np.int64)
            score, cents, cnt_m = _ch_from_labels(X, lab, m)
        else:
            lab = None  # materialized lazily for the winning order only
            score, cents = _ch_from_stats(n, sq_total, overall,
                                          cnt[i, :m], sums[i, :m])
            cnt_m = cnt[i, :m]
        # clusters that won no points keep their trained (stale) centroid
        cents = np.where((cnt_m > 0)[:, None], cents, C[i, :m])
        cand = ClusterModel(lab, cents, m, "kmeans++", score,
                            counts=np.asarray(cnt_m, np.float64).copy())
        if best is None or score > best.ch:
            best, best_i = cand, i
    assert best is not None  # ms non-empty, checked above
    if best.labels is None:
        best.labels = labs[:n, best_i].cpu().numpy().astype(np.int64)
    return best


def fit_clusters(X: np.ndarray, *, m_range: range | None = None,
                 method: str = "kmeans++", seed: int = 0,
                 batched: bool | None = None, batch_size: int = 2048,
                 use_kernel: bool | None = None,
                 device=None) -> ClusterModel:
    """Cluster with CH-index model-order selection (largest CH wins).

    ``method="kmeans++"`` routes to the batched torch path when ``batched``
    is True, or automatically at ``n >= BATCHED_THRESHOLD`` when ``batched``
    is None; the pure-numpy exact path (the small-n oracle) handles the
    rest.  ``method="hac"`` is always the numpy path — its O(n^2) proximity
    matrix is the reason the batched path exists.  ``device`` (None: the
    CUDA card) is resolved on every route, so a machine without a card
    must ask for the CPU by name.
    """
    device = resolve_device(device)
    n = X.shape[0]
    if method == "kmeans++":
        if batched is None:
            batched = n >= BATCHED_THRESHOLD
        if batched:
            return fit_clusters_batched(X, m_range=m_range, seed=seed,
                                        batch_size=batch_size,
                                        use_kernel=use_kernel, device=device)
    elif method != "hac":
        raise ValueError(f"unknown clustering method: {method}")
    if m_range is None:
        m_range = range(2, min(9, max(3, n // 8)))
    best: ClusterModel | None = None
    for m in m_range:
        if m >= n:
            break
        if method == "kmeans++":
            labels, _ = kmeans(X, m, seed=seed)
        else:
            labels = hac_upgma(X, m)
        score = ch_index(X, labels)
        cents = np.stack([X[labels == k].mean(0) if (labels == k).any()
                          else X.mean(0) for k in range(m)])
        cand = ClusterModel(labels, cents, m, method, score,
                            counts=np.bincount(
                                labels, minlength=m).astype(np.float64))
        if best is None or score > best.ch:
            best = cand
    if best is None:
        raise ValueError(
            f"cannot cluster {n} points over m_range={list(m_range)!r}: "
            "need at least 3 points and one order with 2 <= m < n")
    return best
