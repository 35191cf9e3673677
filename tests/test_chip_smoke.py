"""chip_smoke.py on the CPU: it refuses to run off the GPU, and its
phases — train with checkpoint + resume, serve against the plain stage 1,
the retrieval kernel against ``_masked_scores`` + ``lax.top_k`` — pass at
tiny widths (the card runs them at full width)."""

import os
import subprocess
import sys

import chip_smoke

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = ["--synthetic", "true", "--d_dim", "16", "--g_dim", "32",
         "--n_blocks", "1", "--n_heads", "2", "--seq_len", "10",
         "--target_seq_len", "20", "--decoder", "ca", "--embedding", "all",
         "--batch_size", "32"]


def test_chip_smoke_refuses_the_cpu():
    """Exits non-zero, with no result line, when JAX's backend is not
    the GPU."""
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=300, cwd=_ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs the GPU" in out.stderr


def test_phases_pass_at_tiny_width(tmp_path, capsys):
    run = str(tmp_path / "run")
    chip_smoke.phase_train(run, flags=_TINY, users=200, items=100)
    chip_smoke.phase_serve(run, batches=(1, 40))
    chip_smoke.phase_retrieval(n_real_items=3000, b=32, ks=(10, 60))
    out = capsys.readouterr().out
    assert "latest checkpoint epoch 2" in out and "-> epoch 3" in out
    assert out.count("ids match the plain stage 1") == 2
    assert out.count("retrieval: ") >= 7  # embed line + 3 dtypes × 2 k
