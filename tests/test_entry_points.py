"""Entry-point plumbing that runs on the CPU: the compile-cache placement, the
peak table the benchmark divides by, and chip_smoke.py's device guard and
host-side backward-error check."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from ctdirect_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else is set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert path == compile_cache.compile_cache_dir()  # same path every call
    assert calls == [("jax_compilation_cache_dir", path)]
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize(
    "kind,fp64,gbps",
    [
        ("NVIDIA H100 80GB HBM3", 34.0, 3350.0),
        ("NVIDIA H100 PCIe", 26.0, 2000.0),
        ("NVIDIA H100 NVL", 30.0, 3900.0),
    ],
)
def test_peaks_resolve_h100_kinds(kind, fp64, gbps):
    from benchmarks.profile_tick import peaks_for

    row = peaks_for(kind)
    assert (row["tflops_fp64"], row["gbps"]) == (fp64, gbps)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA GeForce RTX 4090"])
def test_peaks_unknown_kind_raises(kind):
    from benchmarks.profile_tick import peaks_for

    with pytest.raises(KeyError):
        peaks_for(kind)


def test_chip_smoke_guard_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "not a GPU" in proc.stderr


def test_chip_smoke_four_cards_on_virtual_mesh(capsys):
    """`--four-cards`' legs at a tiny size on four virtual CPU devices: the
    time-sharded IPM and the batch-sharded tick span the mesh and match the
    single-device programs."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    devs = jax.devices()
    assert len(devs) >= 4
    chip_smoke.four_cards(devs, devs[0], time_shard_n=32, B_per_card=2, N=16)
    out = capsys.readouterr().out
    assert "time-sharded IPM N=32" in out
    assert "batch-sharded tick B=8 N=16" in out


def test_chip_smoke_backward_error_matches_dense():
    """The host backward error chip_smoke reports equals the dense
    |Kx - b| / (|K||x| + |b|) of the reassembled system."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    rng = np.random.default_rng(2)
    Bt, N, bs, wb = 3, 5, 3, 2
    A = rng.standard_normal((Bt, N, bs, bs))
    Bc = rng.standard_normal((Bt, N - 1, bs, bs))
    E = rng.standard_normal((Bt, N, bs, wb))
    F = rng.standard_normal((Bt, wb, wb))
    r = rng.standard_normal((Bt, N, bs))
    rb = rng.standard_normal((Bt, wb))
    X = rng.standard_normal((Bt, N, bs))
    xb = rng.standard_normal((Bt, wb))
    got = chip_smoke.backward_error((A, Bc, E, F, r, rb), X, xb)

    n = N * bs + wb
    want = 0.0
    for k in range(Bt):
        K = np.zeros((n, n))
        for i in range(N):
            sl = slice(i * bs, (i + 1) * bs)
            K[sl, sl] = A[k, i]
            if i + 1 < N:
                sl1 = slice((i + 1) * bs, (i + 2) * bs)
                K[sl, sl1] = Bc[k, i]
                K[sl1, sl] = Bc[k, i].T
            K[sl, N * bs :] = E[k, i]
            K[N * bs :, sl] = E[k, i].T
        K[N * bs :, N * bs :] = F[k]
        x = np.concatenate([X[k].ravel(), xb[k]])
        b = np.concatenate([r[k].ravel(), rb[k]])
        scale = np.abs(K).sum(axis=1).max() * np.abs(x).max() + np.abs(b).max()
        want = max(want, np.abs(K @ x - b).max() / scale)
    np.testing.assert_allclose(got, want, rtol=1e-12)
