"""Profile a train step on the GPU and print where the device time goes.

Runs the benchmark's scanned device-pipeline step (``bench.build_setup``)
under ``jax.profiler`` and reduces the trace (``.xplane.pb``, read with
``jax.profiler.ProfileData``) to:

* device busy time and idle share over the traced window: the union of
  the kernel intervals on the GPU plane's stream lines
  (``Stream #N(...)``, one event per kernel or memset run on the card)
  against first-start..last-end of those events;
* the share of kernel time spent in ops under the ``attention`` name
  scope (``models/attention.mha_apply``): each kernel event names its HLO
  instruction (``hlo_op`` stat, else the kernel name), and the compiled
  step's HLO text maps that instruction to the ``op_name`` metadata of
  everything fused into it. The upper bound counts a kernel when any
  fused op is in the scope, the lower bound when all of them are;
* the top ops by device time.

XLA runs the scanned step's loop body as one CUDA graph
(``command_buffer``), whose kernels all report that one HLO op. Take the
idle share from a default run; for per-op attribution (the attention
share) pass ``--per_op``, which turns command buffers off
(``--xla_gpu_enable_command_buffer=``) so every kernel names its own op.

Usage: python scripts/profile_step.py [--config flagship|men|10m]
                                      [--batch N] [--top 25] [--out FILE]
                                      [--per_op]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--per_op" in sys.argv:  # XLA reads its flags when the backend starts
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()

import jax

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_CALLS = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name → the op_names it covers: its own metadata
    plus, for fusions and calls, every op_name inside the computations it
    calls (recursively)."""
    own, calls, comp_instrs = {}, {}, defaultdict(list)
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        comp_instrs[comp].append(name)
        own[name] = set(_OPNAME.findall(line))
        calls[name] = _CALLS.findall(line)

    memo = {}

    def names(instr, depth=0):
        if instr in memo or depth > 50:
            return memo.get(instr, set())
        out = set(own.get(instr, ()))
        for c in calls.get(instr, ()):
            for inner in comp_instrs.get(c, ()):
                out |= names(inner, depth + 1)
        memo[instr] = out
        return out

    return {n: names(n) for n in own}


def _stats(ev) -> dict:
    out = {}
    for item in ev.stats:
        try:
            k, v = item
        except (TypeError, ValueError):
            continue
        out[str(k)] = v
    return out


def _busy(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(path: str, scopes: dict, scope: str = "attention") -> dict:
    """Device busy/idle and the ``scope`` share from one ``.xplane.pb``;
    ``scopes`` is ``hlo_scopes`` of the traced executable."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit(f"no GPU device plane in {path}: "
                         f"{[p.name for p in pd.planes]}")
    in_scope = re.compile(rf"(^|[/(]){re.escape(scope)}($|[/)])")
    intervals, by_op, samples = [], defaultdict(float), []
    scoped = {"upper": 0.0, "lower": 0.0}
    labels = {}
    # kernel names spell instruction names with "_" for "."
    scopes = {**{k.replace(".", "_"): v for k, v in scopes.items()},
              **scopes}
    for plane in planes:
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                s, d = ev.start_ns, ev.duration_ns
                intervals.append((s, s + d))
                st = _stats(ev)
                if len(samples) < 5:
                    samples.append({"name": ev.name, **{
                        k: str(v)[:120] for k, v in st.items()}})
                op = str(st.get("hlo_op", ev.name))
                by_op[op] += d
                covered = [n for n in scopes.get(op, ()) if "/" in n]
                labels.setdefault(op, sorted(covered)[:1])
                # the scope shows as ".../attention/...", and under autodiff
                # as "jvp(attention)" or "transpose(jvp(attention))"
                hits = [bool(in_scope.search(n)) for n in covered]
                if any(hits):
                    scoped["upper"] += d
                if hits and all(hits):
                    scoped["lower"] += d
    if not intervals:
        raise SystemExit(
            f"no stream events; lines: "
            f"{[(p.name, [l.name for l in p.lines]) for p in planes]}")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _busy(intervals)
    kernel_sum = sum(by_op.values())
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window,
        f"{scope}_share_of_kernel_time": {
            k: v / kernel_sum for k, v in scoped.items()},
        "kernel_time_ms": kernel_sum / 1e6,
        "top_ops": sorted(((n, t / 1e6, " ".join(labels.get(n, []))[:160])
                           for n, t in by_op.items()),
                          key=lambda r: -r[1]),
        "lines": sorted({l.name for p in planes for l in p.lines}),
        "event_samples": samples,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "men", "10m"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--calls", type=int, default=4,
                    help="traced dispatches (each = inner_steps train steps)")
    ap.add_argument("--out", default="", help="also write the summary JSON")
    ap.add_argument("--per_op", action="store_true",
                    help="turn XLA's CUDA graphs off so each kernel is "
                         "attributed to its own HLO op")
    args = ap.parse_args()

    from bench import build_setup

    step, state, attrs, dd, chunks, inner, tc, mc = build_setup(
        args.config, args.batch)
    for _ in range(2):  # compile + warm
        state, losses = step(state, attrs, dd.arrays, chunks[0])
    jax.block_until_ready(losses)

    tmp = tempfile.mkdtemp(prefix="carca_profile_")
    jax.profiler.start_trace(tmp)
    for _ in range(args.calls):
        state, losses = step(state, attrs, dd.arrays, chunks[0])
    jax.block_until_ready(losses)
    jax.profiler.stop_trace()

    paths = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise SystemExit(f"no trace written under {tmp}")
    hlo = step.lower(state, attrs, dd.arrays, chunks[0]).compile().as_text()
    res = reduce_trace(sorted(paths)[-1], hlo_scopes(hlo))
    n_steps = args.calls * inner
    dev = jax.devices()[0]
    res.update(config=args.config, batch=tc.batch_size, steps=n_steps,
               per_op=args.per_op,
               device={"platform": dev.platform, "kind": dev.device_kind})
    print(f"# lines on the GPU plane: {res['lines']}")
    print(f"# kernel event samples: {res['event_samples']}")
    print(f"# {n_steps} train steps, window {res['window_ms']:.3f} ms, "
          f"busy {res['busy_ms']:.3f} ms, idle share "
          f"{res['idle_share']:.4f}, attention share of kernel time "
          f"{res['attention_share_of_kernel_time']}")
    print(f"{'ms/step':>9}  {'%':>5}  op")
    for name, ms, label in res["top_ops"][: args.top]:
        print(f"{ms / n_steps:9.4f}  {100 * ms / res['kernel_time_ms']:5.1f}"
              f"  {name[:40]:40}  {label}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
