"""DFT-matmul transforms (ops/rdft.py) vs numpy FFT (the reference's
FFTW role, src/operators/opr_fourier.f90:101-200).

A two-stage Cooley-Tukey factoring of these matmuls (N = 128*N2 stages)
was tried earlier and removed: its padded-MAC saving lost to the extra
memory passes for the stage intermediates.
"""
import numpy as np
import jax.numpy as jnp

from tlab_tpu.ops import rdft


def test_dense_rdft_vs_numpy():
    rng = np.random.default_rng(7)
    f = rng.standard_normal((256, 6, 256))
    plan = rdft.device_rdft_plan(256, 256, jnp.float64)
    fj = jnp.asarray(f, jnp.float64)
    re, im = rdft.forward_parts(plan, fj)
    ref = np.fft.fft(np.fft.rfft(f, axis=0), axis=2)
    assert np.abs(np.asarray(re) - ref.real).max() < 1e-10
    assert np.abs(np.asarray(im) - ref.imag).max() < 1e-10
    back = rdft.backward_parts(plan, re, im)
    assert np.abs(np.asarray(back) - f).max() < 1e-12
    # split-direction composition == fused composition
    r1, i1 = rdft.forward_x_parts(plan, fj)
    r2, i2 = rdft.fft_z_parts(plan, r1, i1)
    assert np.abs(np.asarray(r2) - ref.real).max() < 1e-10
    r3, i3 = rdft.ifft_z_parts(plan, r2, i2)
    back2 = rdft.backward_x_parts(plan, r3, i3)
    assert np.abs(np.asarray(back2) - f).max() < 1e-12


def test_dft_precision_knob(monkeypatch):
    """The DFT matmuls follow op_precision (cond-1 matrices), here set to
    HIGH; TLAB_TPU_DFT_PRECISION=highest pins them to HIGHEST."""
    import jax
    from tlab_tpu.ops.rdft import _dft_precision
    from tlab_tpu.ops.derivative import op_precision
    monkeypatch.setenv("TLAB_TPU_MATMUL_PRECISION", "high")
    assert _dft_precision(jnp.float32) == op_precision(jnp.float32) \
        == jax.lax.Precision.HIGH
    assert _dft_precision(jnp.float64) == op_precision(jnp.float64)
    monkeypatch.setenv("TLAB_TPU_DFT_PRECISION", "highest")
    assert _dft_precision(jnp.float32) == jax.lax.Precision.HIGHEST
