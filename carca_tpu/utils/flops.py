"""Analytic matmul-FLOP accounting for MFU reporting.

The reference publishes no utilization numbers (SURVEY.md §6) and judging
"fast" against its torch-CPU loop proves nothing about chip utilization.
``bench.py`` divides the analytic model FLOPs/step by measured step time
and the chip's peak to emit an honest MFU alongside raw throughput.

Only matmul FLOPs are counted (the MFU convention): embedding-fusion
linears, attention projections, score/value matmuls, FFN, decoder. Table
gathers, masking, softmax, dropout, the negative sampler's sorts, and the
optimizer are excluded — at CARCA scale (d=64–128) those are exactly the
memory-bound parts MFU is meant to expose as the gap to 100%.

The peak follows the compute dtype: an f32 matmul under the GPU's
DEFAULT precision runs on the tensor cores in TF32, so f32 models divide
by the TF32 peak and ``compute_dtype="bfloat16"`` models by the bf16 peak.
A device missing from the table raises — a utilization without a known
peak is not reported as anything.
"""

from __future__ import annotations

from carca_tpu.config import ModelConfig

# Dense (no sparsity) tensor-core peaks and memory bandwidth per card, at
# the card's full 700 W power limit. Source: NVIDIA H100 SXM data sheet.
# Keys are jax ``device_kind`` strings as the card reports them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 495e12,
                              "hbm_bps": 3.35e12},
}


def _peaks(device) -> dict:
    kind = getattr(device, "device_kind", "")
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no peak rates known for device kind {kind!r} "
                         f"(utils/flops.PEAKS)") from None


def _embed_flops_per_token(mc: ModelConfig) -> float:
    """Matmul FLOPs to fuse one (id, attrs, ctx) token to d dims
    (``models/embeddings.py``; reference formulas ``src/carca.py:66-198``)."""
    a, c, g, d = mc.n_attrs, mc.n_ctx, mc.g, mc.d
    if mc.embedding == "all":
        return 2.0 * (a + c) * g + 2.0 * (g + d) * d
    if mc.embedding == "attrctx":
        return 2.0 * (a + c) * g + 2.0 * g * d
    if mc.embedding == "attr":
        return 2.0 * a * g + 2.0 * g * d
    if mc.embedding == "mlpid":
        return 2.0 * g * d
    return 0.0  # "id": pure table gather


def forward_flops_per_example(mc: ModelConfig, n_targets: int) -> float:
    """Matmul FLOPs of one CARCA forward pass for one example with
    ``n_targets`` candidate tokens (train: 2L, eval: target_len+1).

    Mirrors the compute graph of ``models/carca.py::carca_apply``:
    embed L profile + n_targets target tokens, ``n_blocks`` encoder
    blocks over the profile, decoder over the candidates.
    """
    L, d, T = mc.seq_len, mc.d, n_targets
    f = (L + T) * _embed_flops_per_token(mc)
    # encoder block: Q/K/V projections, L x L scores, weighted values,
    # two d->d FFN convs (models/encoder.py; src/carca.py:297-318)
    per_block = 3 * 2.0 * L * d * d + 2 * 2.0 * L * L * d + 2 * 2.0 * L * d * d
    f += mc.n_blocks * per_block
    if mc.decoder == "ca":
        # cross-attention: Wq over T targets, Wk/Wv over L profile,
        # T x L scores + values, final d->1 linear (src/carca.py:338-349)
        f += 2.0 * T * d * d + 2 * 2.0 * L * d * d
        f += 2 * 2.0 * T * L * d + 2.0 * T * d
    elif mc.decoder == "wdot":
        # closed-form decayed profile mix: [L, L] @ [L, d] per example
        f += 2.0 * L * L * d + 2.0 * T * d
    else:  # dot: elementwise p.o reduction
        f += 2.0 * T * d
    return f


def train_step_flops(mc: ModelConfig, batch_size: int) -> float:
    """Matmul FLOPs of one optimizer step (fwd + bwd) over a batch.

    Backward of a matmul costs 2x its forward (grads w.r.t. both inputs),
    the standard 3x-forward accounting.
    """
    return 3.0 * batch_size * forward_flops_per_example(mc, 2 * mc.seq_len)


def device_peak_flops(device, compute_dtype: str = "float32") -> float:
    """Tensor-core peak FLOP/s of ``device`` for matmuls in
    ``compute_dtype`` (TF32 for "float32", bf16 for "bfloat16"); raises
    on a device missing from ``PEAKS``."""
    return _peaks(device)[str(compute_dtype)]


def device_peak_hbm_bps(device) -> float:
    """Device-memory peak bytes/s; raises on an unknown device."""
    return _peaks(device)["hbm_bps"]


def train_step_hbm_bytes(mc: ModelConfig, batch_size: int,
                         sparse_items: bool = False) -> float:
    """Modeled HBM bytes of one optimizer step (companion to
    ``train_step_flops`` for the bandwidth roofline).

    Counts the traffic classes a CARCA train step cannot avoid at the
    HLO level — optimizer/gradient streams over the parameter tables,
    embedding-table gathers + backward scatter-adds, batch tensors, and
    forward intermediates written to HBM and re-read by the backward
    pass (no remat). Elementwise chains XLA fuses (bias adds, masks,
    activations, dropout) are NOT counted as extra round-trips, so this
    is a best-case model: ``hbm_gbps`` computed from it understates the
    chip's achieved bytes when fusion falls short, and the ratio to the
    HBM peak is a lower bound on how bandwidth-bound the step is.

    Two caveats it deliberately does not model: random-row table
    gathers/scatters move whole memory sectors per row, so their
    *achieved* bytes can exceed the logical row bytes counted here; and
    unique-row scatters sit at a per-row read-modify-write floor that is
    latency-, not bytes-, limited.
    """
    B, L, d, g = batch_size, mc.seq_len, mc.d, mc.g
    T = 2 * L  # train candidates: L positives + L negatives
    a, c = mc.n_attrs, mc.n_ctx
    s = 4  # params/tables/activations are f32 on the hot path; the
    #        bf16 compute_dtype casts happen inside fused matmuls
    tokens = B * (L + T)

    # parameter bytes: items table + attr/ctx fusion MLPs + encoder +
    # decoder (mirrors models/*_init shapes)
    p_table = mc.n_items * d * s
    p_fuse = ((a + c) * g + g + (g + d) * d + d) * s  # fc1 + fc2 (+biases)
    p_enc = mc.n_blocks * (3 * d * d + 2 * d * d + 4 * d) * s
    p_dec = (3 * d * d + d) * s if mc.decoder == "ca" else 0
    p_rest = p_fuse + p_enc + p_dec

    # optimizer stream: bwd writes grads (1), Adam reads g+p+m+v (4) and
    # writes p+m+v (3) = 8 passes over every parameter byte. Lazy
    # row-sparse Adam (train/sparse_adam.py) touches only the gathered
    # rows of the items table; `tokens` is the (duplicate-counting)
    # upper bound on touched rows.
    touched = min(tokens, mc.n_items) * d * s
    opt = 8.0 * ((touched if sparse_items else p_table) + p_rest)

    # table gathers: every token reads its item row + attrs row (+ pos
    # row when encoded); backward scatter-adds d-dim grads (read+write)
    gather = tokens * (d + a) * s
    scatter = 2.0 * tokens * d * s

    # batch tensors: ids, labels, per-event ctx (device pipeline keeps
    # them in HBM between assembly and the step)
    batch_io = tokens * (4 + 4 + c * s)

    # forward intermediates (write fwd + read bwd = 2 passes each),
    # mirroring carca_apply: fused token embeddings [tokens, d] and the
    # g-dim attr/ctx hidden, encoder per block (Q,K,V, scores, softmax,
    # attn out, 2 FFN), decoder (ca: Q,K,V, scores, softmax, out).
    acts = tokens * (g + d)
    acts += mc.n_blocks * (3 * B * L * d + 2 * B * L * L + 2 * B * L * d
                           + 2 * B * L * d)
    if mc.decoder == "ca":
        acts += B * T * d + 2 * B * L * d + 2 * B * T * L + B * T * d
    else:
        acts += B * T * d  # profile mix / score intermediates
    acts_bytes = 2.0 * acts * s

    return opt + gather + scatter + batch_io + acts_bytes
