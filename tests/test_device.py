"""Device-path (jnp on CPU) vs golden bit-exactness (SURVEY.md §4.5 "Kernel"
and "Integration" tiers; SPEC.md §11 invariant 2).

The codec is all-integer, so every assertion here is exact equality. The
same tests run on the card with JAX_PLATFORMS=cuda (conftest.py).
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest

from video_encoder.codec import golden, spec
from video_encoder.codec.config import EncoderConfig
from video_encoder.ops import motion, transform as tx
from video_encoder.pipeline.device_engine import DeviceEngine
from video_encoder.pipeline.encoder import encode_clip, GoldenEngine
from video_encoder.pipeline.decoder import decode_clip


def test_transform_matches_numpy(rng):
    x = rng.integers(-255, 256, size=(32, 8, 8)).astype(np.int32)
    assert np.array_equal(np.asarray(tx.forward_transform(jnp.asarray(x))),
                          spec.forward_transform(x))
    c = spec.forward_transform(x)
    assert np.array_equal(np.asarray(tx.inverse_transform(jnp.asarray(c))),
                          spec.inverse_transform(c))


@pytest.mark.parametrize("lim", [255, 65520])
def test_transform_exact_at_extremes(rng, lim):
    """The int32 dot of the 8x8 transform stays exact at the largest inputs
    the codec gives it: +-255 residuals, +-65520 dequantized coefficients;
    blocks of random signs at the extreme, all +lim, all -lim, and random
    values in range."""
    x = np.concatenate([
        rng.choice(np.array([-lim, lim], np.int32), size=(64, 8, 8)),
        np.full((1, 8, 8), lim, np.int32),
        np.full((1, 8, 8), -lim, np.int32),
        rng.integers(-lim, lim + 1, size=(64, 8, 8)).astype(np.int32),
    ])
    assert np.array_equal(np.asarray(tx.forward_transform(jnp.asarray(x))),
                          spec.forward_transform(x))
    assert np.array_equal(np.asarray(tx.inverse_transform(jnp.asarray(x))),
                          spec.inverse_transform(x))


def test_quant_matches_numpy(rng):
    c = rng.integers(-4095, 4096, size=(500,)).astype(np.int32)
    for qp in (1, 28, 63):
        q = int(spec.QSTEP[qp])
        assert np.array_equal(
            np.asarray(tx.quantize(jnp.asarray(c), jnp.int32(q))),
            spec.quantize(c, q),
        )


def test_zigzag_matches(rng):
    lv = rng.integers(-100, 100, size=(3, 4, 6, 8, 8)).astype(np.int32)
    zz = np.asarray(tx.zigzag(jnp.asarray(lv)))
    assert np.array_equal(zz, lv.reshape(3, 4, 6, 64)[..., spec.ZIGZAG])
    assert np.array_equal(np.asarray(tx.unzigzag(jnp.asarray(zz))), lv)


def test_full_search_matches_golden(rng):
    cur = rng.integers(0, 256, size=(48, 64)).astype(np.int32)
    ref = np.roll(cur, (3, -2), axis=(0, 1))
    gdy, gdx, gsad = golden.sad_full_search(cur, ref)
    ddy, ddx, dsad = motion.full_search(jnp.asarray(cur), jnp.asarray(ref))
    assert np.array_equal(np.asarray(ddy), gdy)
    assert np.array_equal(np.asarray(ddx), gdx)
    assert np.array_equal(np.asarray(dsad), gsad)


def test_diamond_search_matches_golden(rng):
    cur = rng.integers(0, 256, size=(48, 64)).astype(np.int32)
    ref = np.roll(cur, (2, 4), axis=(0, 1))
    gdy, gdx, gsad = golden.sad_diamond_search(cur, ref)
    ddy, ddx, dsad = motion.diamond_search(jnp.asarray(cur), jnp.asarray(ref))
    assert np.array_equal(np.asarray(ddy), gdy)
    assert np.array_equal(np.asarray(ddx), gdx)
    assert np.array_equal(np.asarray(dsad), gsad)


@pytest.mark.parametrize("search,rc", [("full", "none"), ("diamond", "adaptive")])
def test_device_engine_bitstream_equals_golden(small_clip, search, rc):
    """Whole-clip byte-for-byte equality between engines (invariant 2)."""
    cfg = EncoderConfig(width=64, height=48, gop_n=3, base_qp=27, search=search, rc=rc)
    buf_g, buf_d = io.BytesIO(), io.BytesIO()
    encode_clip(cfg, small_clip, buf_g, n_frames=5, engine=GoldenEngine())
    encode_clip(cfg, small_clip, buf_d, n_frames=5, engine=DeviceEngine())
    assert buf_g.getvalue() == buf_d.getvalue()


def test_device_stream_decodes(small_clip):
    cfg = EncoderConfig(width=64, height=48, gop_n=5, base_qp=30)
    buf = io.BytesIO()
    encode_clip(cfg, small_clip, buf, n_frames=5, engine=DeviceEngine())
    buf.seek(0)
    info, frames = decode_clip(buf)
    assert len(list(frames)) == 5


def test_device_intra_only_bitexact(small_clip):
    cfg = EncoderConfig(width=64, height=48, gop_n=1, base_qp=10)
    buf_g, buf_d = io.BytesIO(), io.BytesIO()
    encode_clip(cfg, small_clip, buf_g, n_frames=3, engine=GoldenEngine())
    encode_clip(cfg, small_clip, buf_d, n_frames=3, engine=DeviceEngine())
    assert buf_g.getvalue() == buf_d.getvalue()
