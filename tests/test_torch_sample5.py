"""Kernel K6 (the 5-channel bf16 sampler) against the JAX reference.

`sample_image5_ref`, the plain twin, against
mrhash_tpu/ops/pallas_kernels.py::sample_image_pallas_v2 in interpret mode
on the same inputs, made with numpy from a seed: exactly equal on channels
0-4 (the Pallas kernel's one-hot bf16 contraction selects one element, so
it is exact; channels 5-7 it never writes, PORT_NOTES.md P41, and the port
writes 0 there).  The inputs include patch origins past H - 32 and W - 256,
which the patch slice clamps, and lanes outside the 32x256 patch.

The `gpu` case holds K6 against its twin on the card, exactly
(`python -m pytest --noconftest -m gpu tests/test_torch_sample5.py`).
"""
import numpy as np
import pytest
import torch

from mrhash_tpu_torch.ops import sample_image as SI
from mrhash_tpu_torch.utils.profiler import COUNTS

torch.set_num_threads(1)


def _inputs(seed, H, W, A):
    """A bf16-exact image and per-block origins (8- and 128-aligned, some
    past the clamp) and patch-local lanes (some outside the patch)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0.0, 3.0, (5, H, W)).astype(np.float32)
    img = torch.from_numpy(img).to(torch.bfloat16)
    r0 = (rng.integers(0, H, A) // 8 * 8).astype(np.int32)
    c0 = (rng.integers(0, W, A) // 128 * 128).astype(np.int32)
    r0[0], c0[0] = H - 8, W - 128          # both clamped
    r0[1], c0[1] = 0, 0
    lr = rng.integers(-3, 36, (A, 512)).astype(np.int32)
    lc = rng.integers(-5, 262, (A, 512)).astype(np.int32)
    return img, *(torch.from_numpy(a) for a in (r0, c0, lr, lc))


@pytest.mark.parametrize("H,W,A", [(48, 384, 16), (32, 256, 8)])
def test_twin_matches_pallas_interpret(H, W, A):
    """Twin against sample_image_pallas_v2(interpret=True): channels 0-4
    equal to the bit, channels 5-7 zero."""
    import jax.numpy as jnp
    from mrhash_tpu.ops.pallas_kernels import sample_image_pallas_v2

    img, r0, c0, lr, lc = _inputs(H + W, H, W, A)
    want = np.asarray(sample_image_pallas_v2(
        jnp.asarray(img.to(torch.float32).numpy(), jnp.bfloat16),
        *(jnp.asarray(t.numpy()) for t in (r0, c0, lr, lc)),
        interpret=True))
    got = SI.sample_image5(img, r0, c0, lr, lc)
    assert got.shape == (A, 8, 512) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[:, :5].numpy(), want[:, :5])
    assert not got[:, 5:].any()
    inside = ((lr >= 0) & (lr < 32) & (lc >= 0) & (lc < 256)).numpy()
    assert 0 < inside.mean() < 1
    assert (got[:, 0].numpy()[inside] != 0).mean() > 0.99


def test_wrapper_rejects_contract_violations():
    img, r0, c0, lr, lc = _inputs(0, 48, 384, 16)
    with pytest.raises(ValueError):
        SI.sample_image5(img[:, :31], r0, c0, lr, lc)         # H < 32
    with pytest.raises(ValueError):
        SI.sample_image5(img, r0[:12], c0[:12], lr[:12], lc[:12])  # A % 8
    with pytest.raises(ValueError):
        SI.sample_image5(img.to(torch.float32), r0, c0, lr, lc)


@pytest.mark.gpu
def test_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("K6 is a CUDA kernel: needs a card")
    img, r0, c0, lr, lc = (t.cuda() for t in _inputs(1, 680, 1200, 4096))
    n0 = COUNTS["sample_image5"]
    got = SI.sample_image5(img, r0, c0, lr, lc)
    want = SI.sample_image5_ref(img, r0, c0, lr, lc)
    assert COUNTS["sample_image5"] == n0 + 1
    assert torch.equal(got, want)
