"""On-device negative sampling.

The reference draws fresh negatives per example per epoch with a Python
rejection loop (``src/data.py:77-87``) — the CPU bottleneck flagged in
SURVEY.md §3.1. At scale the framework samples on device instead: uniform
ids in ``[1, n_items-1]`` with a fixed number of retry draws rejecting
collisions against the *visible profile window*, then an overdraw-and-
dedupe pass that makes each row's negatives **distinct** (exact sampling
without replacement — the reference's semantics — at any catalog size;
see ``device_sample_negatives``).

Approximation note (documented at ``DataConfig.device_sampling``): the
reference rejects against the user's full history; on device only the
length-L window is resident unless ``reject_width`` widens it (the
``DataConfig.exact_rejection`` policy). For the catalogs the window-only
mode targets (≥100k items) the acceptance probability per draw is
≥ 1 − L/n_items ≈ 0.999, and the chance any of the ``retries`` draws all
collide is negligible; the final draw is used unconditionally in that
case (keeps shapes static).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp


def retries_for(reject_width: int, n_items: int,
                popularity: bool = False) -> int:
    """Retry count making the all-draws-collide fallback negligible.

    Uniform draws: collision probability per draw is ≤
    reject_width/(n_items − 1); pick R so p^R ≤ 1e−12. Production catalogs
    (≥100k items) stay at the default 8; only tiny catalogs with wide
    reject sets (tests, toy runs) pay for more draws. Capped at 64 —
    beyond that the reject set nearly covers the catalog and rejection
    sampling is the wrong tool anyway.

    Popularity draws collide with the (popularity-biased) history at a
    rate independent of catalog size — a history of popular items can
    carry tens of percent of the unigram mass — so the bound uses a
    pessimistic p = 0.35 floor (R = 24, p^R < 1e−12) instead of the
    uniform estimate.
    """
    p = min(reject_width / max(n_items - 1, 1), 0.999)
    if popularity:
        p = max(p, 0.35)
    if p <= 0.03:  # 0.03^8 < 1e-12
        return 8
    return max(8, min(64, math.ceil(-12.0 / math.log10(p))))


def overdraw_for(n_slots: int, n_items: int, reject_width: int) -> int | None:
    """Candidate count for the WOR-by-dedupe sampler, or None if infeasible.

    Drawing O ids iid-uniform over the *whole* id range, discarding those
    that hit the reject window, and keeping the first ``n_slots`` distinct
    survivors in draw order is exactly uniform sampling without
    replacement over the allowed set (the accepted subsequence is iid
    uniform over it, and the distinct values of an iid sequence form a
    uniform random permutation prefix). The margin ``m = O − n_slots``
    must absorb both expected window hits (O·W/(n−1)) and expected
    duplicates (O²/(2A), A = allowed-set size) with a large deviation;
    m ≥ D + 10·√(D + 0.15) + 4 keeps the Poisson tail of a short row
    ≲ 1e−12 per row (the failure mode is a duplicate or window item
    slipping into the tail slots — the same class of fallback the old
    retry sampler documented; shapes stay static).

    Returns None when no O ≤ 4·n_slots + 2·reject_width + 64 satisfies
    the margin (slots close to the catalog size — coupon-collector
    regime), where the dense top-k path is the right tool instead.
    """
    a = n_items - 1 - reject_width  # pessimistic allowed-set size
    if a <= n_slots:
        return None
    p_win = reject_width / max(n_items - 1, 1)
    cap = 4 * n_slots + 2 * reject_width + 64
    o = n_slots + 8
    while o <= cap:
        d = o * o / (2.0 * a) + o * p_win
        if o - n_slots >= d + 10.0 * math.sqrt(d + 0.15) + 4.0:
            return o
        o += 8
    return None


def _first_distinct_excluding(draws: jnp.ndarray, window: jnp.ndarray,
                              n_slots: int) -> jnp.ndarray:
    """[B, O] iid draws → the first ``n_slots`` distinct values in draw
    order that do NOT appear in ``window`` [B, W].

    The window is merged INTO the dedupe sort: window entries are
    concatenated ahead of the draws, so in the stable value-sort each
    window id heads its equal-value run and every draw that collides with
    it is marked a duplicate by the same prev-equal rule that removes
    repeated draws. This replaces the old per-draw retry machinery — a
    [B, O, R, W] all-pairs compare (226M ops/step at the men shape) —
    with two stable [B, W+O] sorts. Ranking prefers good draws (by draw
    order), then duplicate draws, then window entries, so the ≲1e−12
    short-row fallback degrades to a repeated negative before it ever
    emits a false (window) negative."""
    b, o = draws.shape
    w = window.shape[1]
    vals = jnp.concatenate([window.astype(draws.dtype), draws], axis=1)
    tag = jnp.concatenate(
        [jnp.zeros((w,), jnp.int32), jnp.arange(1, o + 1, dtype=jnp.int32)])
    tags = jnp.broadcast_to(tag, (b, w + o))
    sv, st = jax.lax.sort((vals, tags), num_keys=1)  # stable: window first
    prev_eq = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.bool_), sv[:, 1:] == sv[:, :-1]], axis=1)
    # whether each element's equal-value RUN is headed by a window entry
    # (stability puts window ids at their run's head): pack the head's
    # window flag into the LSB of its position and propagate it with ONE
    # cummax — positions increase, so each run's head dominates. The
    # obvious alternative (cummax head positions, then gather the head's
    # tag with take_along_axis) adds a per-element gather to the scanned
    # train step; the LSB pack is pure vector ops
    pos2 = jnp.broadcast_to(jnp.arange(w + o, dtype=jnp.int32), sv.shape)
    enc = jnp.where(~prev_eq, pos2 * 2 + (st == 0), -1)
    head_win = (jax.lax.cummax(enc, axis=1) & 1) == 1
    big = jnp.int32(2 * (w + o))
    # rank order implements the documented tail preference: good draws (in
    # draw order), then repeated draws, then window-colliding draws, then
    # the window entries themselves — the ≲1e−12 short-row fallback emits
    # a repeated negative before it ever emits a false (window) negative
    rank = jnp.where(st == 0, 4 * big,
                     jnp.where(head_win, 2 * big + st,
                               jnp.where(prev_eq, big + st, st)))
    _, out = jax.lax.sort((rank, sv), num_keys=1)
    return out[:, :n_slots]


@partial(jax.jit, static_argnums=(2, 3, 4))
def device_sample_negatives(
    rng: jax.Array,
    profile: jnp.ndarray,
    n_items: int,
    n_slots: int,
    retries: int = 8,
    events: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Sample ``[B, n_slots]`` negative ids avoiding ``profile`` [B, L],
    **without replacement** within each row (the reference's semantics:
    distinct negatives, excluding the reject set, ``src/data.py:77-87``).

    Default domain matches the reference's sampler:
    ``random.randint(1, n_items-1)`` is inclusive on both ends
    (``src/data.py:82``), i.e. uniform over ``{1, …, n_items-1}`` —
    exactly ``jax.random.randint(…, 1, n_items)``.

    Mechanism: overdraw O uniform ids per row and keep the first
    ``n_slots`` distinct non-window survivors in draw order — exact WOR
    at any catalog size where the overdraw is feasible, with the window
    rejection folded into the same dedupe sort
    (``_first_distinct_excluding``; no retry draws, no [B, O, R, W]
    compare). When slots approach the catalog size (coupon-collector
    regime, ``overdraw_for`` → None) catalogs ≤ 32768 ids fall back to a
    dense top-k of iid uniform keys (still exact WOR); beyond that the
    retry sampler runs and within-row repeats become possible — a
    configuration no target config is near (it needs n_slots ≳ catalog/4
    at >32k items).

    With ``events`` (the CSR event-item array) draws are **popularity-
    proportional** instead: a uniform random event's item id IS a draw
    from the empirical unigram distribution — one extra [B·S·R] gather,
    no CDF table. No reference counterpart (its sampler is uniform-only);
    this exists because uniform negatives over an extreme-sparsity
    catalog never teach the model about the items it actually serves
    (docs/DESIGN.md #11). Popularity draws keep within-row duplicates
    (dedupe would distort the distribution toward the tail) and so keep
    the retry-rejection machinery.
    """
    b = profile.shape[0]
    overdraw = (overdraw_for(n_slots, n_items, profile.shape[1])
                if events is None else None)
    if overdraw is not None:
        draws = jax.random.randint(
            rng, (b, overdraw), 1, n_items, dtype=profile.dtype)
        return _first_distinct_excluding(draws, profile, n_slots)
    if events is None and n_slots < n_items <= 32768:
        # coupon-collector regime (slots ≈ catalog): exact WOR via top-k
        # of iid uniform keys over the whole id space
        keys = jax.random.uniform(rng, (b, n_items))
        keys = keys.at[:, 0].set(-jnp.inf)  # pad id never sampled
        keys = keys.at[jnp.arange(b)[:, None], profile].set(-jnp.inf)
        _, ids = jax.lax.top_k(keys, n_slots)
        return ids.astype(profile.dtype)
    if events is not None:
        eidx = jax.random.randint(
            rng, (b, n_slots, retries), 0, events.shape[0], jnp.int32)
        draws = events[eidx].astype(profile.dtype)
    else:
        draws = jax.random.randint(
            rng, (b, n_slots, retries), 1, n_items, dtype=profile.dtype)
    # collision of each draw against the window: [B, S, R] via all-pairs
    # compare — vector work instead of a [B, n_items] scatter/gather bitmap
    hit = jnp.any(draws[:, :, :, None] == profile[:, None, None, :], axis=-1)
    # first non-colliding draw; fall back to the last draw if all collide
    first_ok = jnp.argmax(~hit, axis=-1)  # 0 if none ok → but then use last
    any_ok = jnp.any(~hit, axis=-1)
    idx = jnp.where(any_ok, first_ok, retries - 1)
    return jnp.take_along_axis(draws, idx[..., None], axis=-1)[..., 0]
