"""Deterministic synthetic datasets for tests and benchmarks.

Two generative processes, both emitting a ``Catalog``:

* **zipf** (v1): items drawn iid from Zipf(1), attrs/ctx iid normal.
  DESIGN §11c finding 9 proved this task is *saturated* — with no
  sequential or preference structure, a static popularity ranking is
  the Bayes-optimal retriever and the production recipe already serves
  95% of that ceiling, so no further quality claim on it is falsifiable.
* **markov** (v2, round 5): a cluster-Markov process with real
  preference + sequential structure. Items partition into K contiguous
  attribute clusters; each user has a private 3-cluster preference
  mixture; each next event's cluster mixes a global cluster→cluster
  Markov transition (weight ``alpha``) with the user's preference; the
  item within the cluster is a two-tier Zipf (a hot head + full-block
  tail). The Bayes-optimal retriever therefore *must* read the history
  (last item's cluster) and the user profile — exactly the behaviors
  the model exists to reward (``src/carca.py:66-198`` feature fusion,
  ``:204-265`` sequential attention) and a popularity table cannot.
  ``scripts/popularity_oracle.py --process markov`` measures both the
  popularity baseline and the generative Bayes ceiling from the true
  process parameters.

Both have a numpy golden source (tests) and an on-device twin (the 10M
preset generates directly in HBM; PRNG pinned to threefry2x32). Also
writes the reference's on-disk formats (profiles txt / pickled attrs /
pickled ctx dict, ``src/data.py:17-50``) for loader round-trip tests.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import numpy as np

from carca_tpu.data.loaders import Catalog


def synthetic_catalog(
    n_users: int = 2000,
    n_real_items: int = 1000,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    seed: int = 0,
) -> Catalog:
    rng = np.random.default_rng(seed)

    # zipf-ish popularity over real item ids [1, n_real_items]
    ranks = np.arange(1, n_real_items + 1, dtype=np.float64)
    popularity = 1.0 / ranks
    popularity /= popularity.sum()

    lengths = rng.integers(min_len, max_len + 1, size=n_users)
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    n_events = int(offsets[-1])

    items = rng.choice(
        np.arange(1, n_real_items + 1, dtype=np.int32), size=n_events, p=popularity
    )
    ctx_vals = rng.standard_normal((n_events, n_ctx)).astype(np.float32)

    attrs = rng.standard_normal((n_real_items + 1, n_attrs)).astype(np.float32)
    attrs[0] = 0.0  # pad row (src/data.py:33-34)

    return Catalog(
        attrs=attrs,
        user_ids=np.arange(n_users, dtype=np.int64),
        items=items.astype(np.int32),
        offsets=offsets,
        ctx_vals=ctx_vals,
    )


def synthetic_catalog_device(
    n_users: int = 2000,
    n_real_items: int = 1000,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    seed: int = 0,
) -> Catalog:
    """``synthetic_catalog`` with the big arrays generated ON the
    accelerator.

    The host variant materializes attrs ``[n_items+1, A]`` and per-event
    context in host RAM and ships them to HBM — for the 10M-item preset
    that is ~0.5–2.6 GB of host→device traffic before the first step.
    Here only the ``[n_users+1]`` CSR offsets cross the boundary; attrs,
    items, and contexts are generated directly in device memory. The PRNG
    impl is pinned to threefry2x32 — stable across backends and XLA
    versions — so a catalog generated during training is regenerated
    bit-identically by carca-serve or a resumed run on any backend, even
    when ``CARCA_PRNG_IMPL`` picks a backend-dependent generator (fine for
    dropout, wrong for data). Item popularity uses the continuous Zipf(1) inverse CDF
    (``exp(u·ln n)``) rather than numpy's exact discrete draw — the same
    1/rank shape, different PRNG stream, so the numpy generator remains
    the deterministic golden source for tests.
    """
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, max_len + 1, size=n_users)
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    n_events = int(offsets[-1])

    root = jax.random.key(seed, impl="threefry2x32")
    k_items, k_ctx, k_attrs = jax.random.split(root, 3)

    @jax.jit
    def gen():
        u = jax.random.uniform(k_items, (n_events,), jnp.float32)
        items = jnp.clip(
            jnp.exp(u * jnp.log(float(n_real_items))).astype(jnp.int32),
            1, n_real_items)
        ctx_vals = jax.random.normal(k_ctx, (n_events, n_ctx), jnp.float32)
        attrs = jax.random.normal(
            k_attrs, (n_real_items + 1, n_attrs), jnp.float32)
        attrs = attrs.at[0].set(0.0)  # pad row (src/data.py:33-34)
        return items, ctx_vals, attrs

    items, ctx_vals, attrs = gen()
    return Catalog(
        attrs=attrs,
        user_ids=np.arange(n_users, dtype=np.int64),
        items=items,
        offsets=offsets,
        ctx_vals=ctx_vals,
    )


# --------------------------------------------------------------------
# v2 "markov" process: per-user cluster preferences + cluster-Markov
# transitions + two-tier within-cluster Zipf (module docstring).
# --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MarkovProcess:
    """The TRUE parameters of the v2 generative process — enough for the
    generative-Bayes oracle in scripts/popularity_oracle.py to compute the
    exact next-item posterior (the calibration ceiling for every learned
    retrieval number on this task)."""
    n_users: int
    n_real_items: int
    n_clusters: int
    n_attrs: int
    n_ctx: int
    alpha: float          # weight of the Markov term in the cluster mix
    hot_frac: float       # P(draw from the cluster's hot head)
    hot_items: int        # head size (per cluster, capped at block size)
    attr_noise: float     # attrs = centroid[c] + noise·N(0,1)
    trans: np.ndarray     # [K, K] row-stochastic cluster transitions
    pref: np.ndarray      # [U, K] per-user preference mixture (3 clusters)
    centroids: np.ndarray  # [K, A]
    lengths: np.ndarray   # [U] profile lengths
    offsets: np.ndarray   # [U+1] CSR

    @property
    def bounds(self) -> np.ndarray:
        """[K+1] cluster block bounds: cluster c owns real item ids
        (bounds[c], bounds[c+1]] — contiguous blocks make cluster-of-item
        and within-cluster rank analytic (rank = id - bounds[c])."""
        return cluster_bounds(self.n_real_items, self.n_clusters)


def cluster_bounds(n_real_items: int, n_clusters: int) -> np.ndarray:
    return (np.arange(n_clusters + 1, dtype=np.int64)
            * n_real_items) // n_clusters


def cluster_of(item_ids, bounds):
    """Cluster index of real item ids (>= 1) under contiguous blocks.
    Works for numpy or jnp arrays (searchsorted over [K+1] bounds)."""
    if isinstance(item_ids, np.ndarray) or np.isscalar(item_ids):
        return np.searchsorted(bounds, np.asarray(item_ids) - 1,
                               side="right") - 1
    import jax.numpy as jnp
    return jnp.searchsorted(jnp.asarray(bounds), item_ids - 1,
                            side="right") - 1


def markov_process(
    n_users: int,
    n_real_items: int,
    n_clusters: int = 64,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    alpha: float = 0.6,
    hot_frac: float = 0.75,
    hot_items: int = 2000,
    attr_noise: float = 0.3,
    seed: int = 0,
) -> MarkovProcess:
    """Draw the (small) true parameters on the host — deterministic numpy,
    shared verbatim by the host generator, the device generator, and the
    oracle, so all three see ONE process for a given seed.

    Transition rows: 0.35 self + 0.30/0.20 on two random successor
    clusters + 0.15 spread uniformly — every entry positive, but the mass
    concentrated enough that knowing the last item's cluster is worth
    ~0.6 of the posterior (alpha)."""
    if n_clusters > n_real_items:
        raise ValueError(f"n_clusters {n_clusters} > n_items {n_real_items}")
    rng = np.random.default_rng(seed)
    K = n_clusters

    trans = np.full((K, K), 0.15 / K, np.float64)
    for c in range(K):
        others = rng.permutation(np.delete(np.arange(K), c))[:2]
        trans[c, c] += 0.35
        if len(others) >= 1:
            trans[c, others[0]] += 0.30 if len(others) >= 2 else 0.50
        if len(others) >= 2:
            trans[c, others[1]] += 0.20
        else:
            trans[c, c] += 0.0 if len(others) >= 1 else 0.50
    trans /= trans.sum(axis=1, keepdims=True)  # exact row-stochastic

    # 3 distinct preferred clusters per user, weights 0.5/0.3/0.2
    n_pref = min(3, K)
    picks = np.argpartition(rng.random((n_users, K)), n_pref - 1,
                            axis=1)[:, :n_pref]
    w = np.array([0.5, 0.3, 0.2][:n_pref], np.float64)
    w /= w.sum()
    pref = np.zeros((n_users, K), np.float32)
    np.put_along_axis(pref, picks, w.astype(np.float32)[None, :], axis=1)

    centroids = rng.standard_normal((K, n_attrs)).astype(np.float32)

    lengths = rng.integers(min_len, max_len + 1, size=n_users)
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return MarkovProcess(
        n_users=n_users, n_real_items=n_real_items, n_clusters=K,
        n_attrs=n_attrs, n_ctx=n_ctx, alpha=alpha, hot_frac=hot_frac,
        hot_items=hot_items, attr_noise=attr_noise, trans=trans, pref=pref,
        centroids=centroids, lengths=lengths, offsets=offsets)


def _rank_pmf_weights(proc: MarkovProcess) -> tuple:
    """Per-cluster within-block rank pmf pieces for the oracle:
    P(rank=r | cluster c) = hot_frac·ln(1+1/r)/ln(m_hot)·[r<m_hot]
                          + (1-hot_frac)·ln(1+1/r)/ln(m_c)·[r<m_c]
    (floor(exp(u·ln m)) never hits m — measure zero)."""
    sizes = np.diff(proc.bounds)
    m_hot = np.minimum(proc.hot_items, sizes)
    return sizes, m_hot


def markov_rank_pmf(proc: MarkovProcess, ranks: np.ndarray,
                    cluster: np.ndarray) -> np.ndarray:
    """P(within-cluster rank | cluster) under the two-tier Zipf draw —
    the exact pmf of ``clip(floor(exp(u·ln m)), 1, m)``."""
    sizes, m_hot = _rank_pmf_weights(proc)
    m_full = sizes[cluster].astype(np.float64)
    mh = m_hot[cluster].astype(np.float64)
    r = ranks.astype(np.float64)
    base = np.log1p(1.0 / r)
    # ln(m)=0 for single-item blocks: the draw is deterministic rank 1
    hot = np.where((r < mh),
                   base / np.maximum(np.log(mh), 1e-12), 0.0)
    hot = np.where(mh <= 1.0, (r == 1.0).astype(np.float64), hot)
    full = np.where((r < m_full),
                    base / np.maximum(np.log(m_full), 1e-12), 0.0)
    full = np.where(m_full <= 1.0, (r == 1.0).astype(np.float64), full)
    return proc.hot_frac * hot + (1.0 - proc.hot_frac) * full


def _categorical_rows(rng: np.random.Generator, p: np.ndarray) -> np.ndarray:
    """Sample one index per row of a [N, K] probability matrix
    (Gumbel-argmax: vectorized, no per-row loop)."""
    g = rng.gumbel(size=p.shape)
    return np.argmax(np.log(np.maximum(p, 1e-38)) + g, axis=1)


def _markov_clusters_numpy(proc: MarkovProcess, rng: np.random.Generator,
                           max_len: int) -> np.ndarray:
    """[U, max_len] cluster sequence: c_0 ~ pref, c_t ~ α·T[c_{t-1}] +
    (1-α)·pref."""
    U = proc.n_users
    seq_c = np.zeros((U, max_len), np.int64)
    c = _categorical_rows(rng, proc.pref)
    seq_c[:, 0] = c
    for t in range(1, max_len):
        p = proc.alpha * proc.trans[c] + (1.0 - proc.alpha) * proc.pref
        c = _categorical_rows(rng, p)
        seq_c[:, t] = c
    return seq_c


def _items_within_clusters_numpy(proc: MarkovProcess,
                                 rng: np.random.Generator,
                                 seq_c: np.ndarray) -> np.ndarray:
    """Two-tier Zipf item draw for every (user, t) cluster assignment."""
    sizes, m_hot = _rank_pmf_weights(proc)
    m_full = sizes[seq_c]
    mh = m_hot[seq_c]
    m = np.where(rng.random(seq_c.shape) < proc.hot_frac, mh, m_full)
    u = rng.random(seq_c.shape)
    rank = np.clip(np.floor(np.exp(u * np.log(m))).astype(np.int64), 1, m)
    return proc.bounds[seq_c] + rank


def synthetic_catalog_markov(
    n_users: int = 2000,
    n_real_items: int = 1000,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    seed: int = 0,
    proc: MarkovProcess | None = None,
    **proc_kw,
) -> Catalog:
    """Host-numpy v2 catalog — the deterministic golden source for tests.
    Pass ``proc`` to reuse an existing process (the oracle does)."""
    if proc is None:
        proc = markov_process(n_users, n_real_items, n_attrs=n_attrs,
                              n_ctx=n_ctx, min_len=min_len, max_len=max_len,
                              seed=seed, **proc_kw)
    rng = np.random.default_rng(seed + 1)  # event stream: distinct from proc
    T = int(proc.lengths.max())
    seq_c = _markov_clusters_numpy(proc, rng, T)
    items2d = _items_within_clusters_numpy(proc, rng, seq_c)
    keep = np.arange(T)[None, :] < proc.lengths[:, None]
    items = items2d[keep].astype(np.int32)  # row-major → CSR event order
    n_events = int(proc.offsets[-1])
    assert items.shape[0] == n_events
    ctx_vals = rng.standard_normal((n_events, proc.n_ctx)).astype(np.float32)

    attrs = (proc.centroids[cluster_of(
        np.arange(1, proc.n_real_items + 1), proc.bounds)]
        + proc.attr_noise
        * rng.standard_normal((proc.n_real_items, proc.n_attrs)))
    attrs = np.concatenate(
        [np.zeros((1, proc.n_attrs), np.float32),  # pad row (src/data.py:33-34)
         attrs.astype(np.float32)], axis=0)

    return Catalog(
        attrs=attrs,
        user_ids=np.arange(proc.n_users, dtype=np.int64),
        items=items,
        offsets=proc.offsets,
        ctx_vals=ctx_vals,
    )


def synthetic_catalog_markov_device(
    n_users: int = 2000,
    n_real_items: int = 1000,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    seed: int = 0,
    proc: MarkovProcess | None = None,
    **proc_kw,
) -> Catalog:
    """v2 catalog with the BIG arrays generated on the accelerator (same
    HBM-direct rationale as ``synthetic_catalog_device``; PRNG pinned to
    threefry2x32 so serve/resume regenerate bit-identically on any
    backend). Only the small true-process tensors (transitions [K,K],
    prefs [U,K], centroids [K,A], CSR offsets) cross host→device.
    Different PRNG stream from the numpy twin — the numpy generator
    stays the golden source for tests; the PROCESS (trans/pref/
    centroids/lengths) is shared exactly."""
    import jax
    import jax.numpy as jnp

    if proc is None:
        proc = markov_process(n_users, n_real_items, n_attrs=n_attrs,
                              n_ctx=n_ctx, min_len=min_len, max_len=max_len,
                              seed=seed, **proc_kw)
    T = int(proc.lengths.max())
    n_events = int(proc.offsets[-1])
    sizes, m_hot = _rank_pmf_weights(proc)

    root = jax.random.key(seed, impl="threefry2x32")
    k_seq, k_tier, k_rank, k_ctx, k_attr = jax.random.split(root, 5)

    trans = jnp.asarray(proc.trans, jnp.float32)
    pref = jnp.asarray(proc.pref, jnp.float32)
    bounds = jnp.asarray(proc.bounds, jnp.int32)
    sizes_d = jnp.asarray(sizes, jnp.int32)
    m_hot_d = jnp.asarray(m_hot, jnp.int32)
    offsets = jnp.asarray(proc.offsets, jnp.int32)
    centroids = jnp.asarray(proc.centroids, jnp.float32)

    @jax.jit
    def gen():
        U = proc.n_users
        logp0 = jnp.log(jnp.maximum(pref, 1e-38))
        keys = jax.random.split(k_seq, T)
        c0 = jnp.argmax(
            logp0 + jax.random.gumbel(keys[0], (U, proc.n_clusters)), axis=1)

        def step(c, key):
            p = proc.alpha * trans[c] + (1.0 - proc.alpha) * pref
            g = jax.random.gumbel(key, (U, proc.n_clusters))
            c2 = jnp.argmax(jnp.log(jnp.maximum(p, 1e-38)) + g, axis=1)
            return c2, c2
        _, rest = jax.lax.scan(step, c0, keys[1:])
        seq_c = jnp.concatenate([c0[None], rest], axis=0).T  # [U, T]

        m_full = sizes_d[seq_c]
        mh = m_hot_d[seq_c]
        tier = jax.random.uniform(k_tier, (U, T)) < proc.hot_frac
        m = jnp.where(tier, mh, m_full).astype(jnp.float32)
        u = jax.random.uniform(k_rank, (U, T))
        rank = jnp.clip(jnp.exp(u * jnp.log(m)).astype(jnp.int32),
                        1, m.astype(jnp.int32))
        items2d = (bounds[seq_c] + rank).astype(jnp.int32)

        # CSR flatten: event e belongs to user searchsorted(offsets)-1 at
        # position e - offsets[u] (device-side; ~one gather per event)
        e = jnp.arange(n_events, dtype=jnp.int32)
        ue = jnp.searchsorted(offsets, e, side="right").astype(jnp.int32) - 1
        pe = e - offsets[ue]
        items = items2d[ue, pe]

        ctx_vals = jax.random.normal(k_ctx, (n_events, proc.n_ctx),
                                     jnp.float32)
        cl = jnp.searchsorted(
            bounds, jnp.arange(proc.n_real_items + 1, dtype=jnp.int32) - 1,
            side="right") - 1  # id 0 → cluster -1 → row overwritten below
        attrs = (centroids[jnp.maximum(cl, 0)]
                 + proc.attr_noise * jax.random.normal(
                     k_attr, (proc.n_real_items + 1, proc.n_attrs),
                     jnp.float32))
        attrs = attrs.at[0].set(0.0)  # pad row (src/data.py:33-34)
        return items, ctx_vals, attrs

    items, ctx_vals, attrs = gen()
    return Catalog(
        attrs=attrs,
        user_ids=np.arange(proc.n_users, dtype=np.int64),
        items=items,
        offsets=proc.offsets,
        ctx_vals=ctx_vals,
    )


def synthetic_generator(process: str, device: bool):
    """Resolve a DataConfig.synthetic_process + placement to a generator —
    the single mapping shared by training (cli.load_catalog) and serving
    (serve/service.load_catalog_for_run), so a run's catalog is always
    regenerable from its args.json alone."""
    try:
        return {
            ("zipf", False): synthetic_catalog,
            ("zipf", True): synthetic_catalog_device,
            ("markov", False): synthetic_catalog_markov,
            ("markov", True): synthetic_catalog_markov_device,
        }[(process, device)]
    except KeyError:
        raise ValueError(
            f"unknown synthetic_process {process!r} (zipf|markov)") from None


def write_reference_format(cat: Catalog, out_dir: str, dedup_ctx: bool = True) -> None:
    """Dump a Catalog in the reference's file formats.

    Note the ctx dict is keyed by (user, item) (``src/data.py:17-25``) — if a
    user repeats an item, only one context vector survives, exactly as in the
    reference format.
    """
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profiles.txt"), "w") as fh:
        for u in range(cat.n_users):
            uid = int(cat.user_ids[u])
            for e in range(cat.offsets[u], cat.offsets[u + 1]):
                fh.write(f"{uid} {int(cat.items[e])}\n")

    # attrs pickle excludes the pad row (loader re-prepends it)
    with open(os.path.join(out_dir, "attrs.pkl"), "wb") as fh:
        pickle.dump(cat.attrs[1:], fh)

    ctx = {}
    for u in range(cat.n_users):
        uid = int(cat.user_ids[u])
        for e in range(cat.offsets[u], cat.offsets[u + 1]):
            ctx[(uid, int(cat.items[e]))] = cat.ctx_vals[e].tolist()
    with open(os.path.join(out_dir, "ctx.pkl"), "wb") as fh:
        pickle.dump(ctx, fh)


def canonicalize_repeat_ctx(cat: Catalog) -> Catalog:
    """Apply the reference's (user, item)-keyed context semantics: when a
    user repeats an item, every occurrence uses the dict's surviving (last)
    context vector (``src/data.py:17-25`` + dict insertion order)."""
    ctx_vals = cat.ctx_vals.copy()
    for u in range(cat.n_users):
        s, e = int(cat.offsets[u]), int(cat.offsets[u + 1])
        last = {}
        for i in range(s, e):
            last[int(cat.items[i])] = i
        for i in range(s, e):
            ctx_vals[i] = cat.ctx_vals[last[int(cat.items[i])]]
    return Catalog(cat.attrs, cat.user_ids, cat.items, cat.offsets, ctx_vals)
