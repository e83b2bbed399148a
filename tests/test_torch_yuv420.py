"""The port's 4:2:0 wire against the JAX package's: the device conversion
(preprocessing/yuv420.py) bit for bit on seeded planes, the whole wire (the
port's native loader, then its conversion) bit for bit against PIL, the
port's packed loads, and ``encode_video`` on packed input. Tolerances are
stated at each comparison; the wire's are all exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_engine import port_cfg
from video_caption_tpu.models import caption_model as jcm
from video_caption_tpu.preprocessing import yuv420 as jyuv
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models.convert import params_from_jax_numpy
from video_caption_tpu_torch.native import loader
from video_caption_tpu_torch.preprocessing import frame_loader
from video_caption_tpu_torch.preprocessing import yuv420


@pytest.fixture()
def native():
    """The port's C++ loader (it builds atomically, so parallel workers agree
    on whether it is there): decided here, not when the module is imported."""
    if not loader.native_available():
        pytest.skip(f"the port's native loader does not build here: {loader.last_error}")


def _images(size=224):
    rng = np.random.RandomState(7)
    grad = np.stack(np.meshgrid(np.arange(size), np.arange(size)), -1).sum(-1)
    return [
        rng.randint(0, 255, (size, size, 3), np.uint8),                      # noise
        (grad[..., None] % 256).repeat(3, -1).astype(np.uint8),              # gradient
        (np.sin(np.arange(size * size * 3).reshape(size, size, 3) / 997.0)
         * 127 + 128).astype(np.uint8),                                      # structure
        np.full((size, size, 3), 3, np.uint8),                               # clips low
        np.full((size, size, 3), 252, np.uint8),                             # clips high
    ]


@pytest.fixture(scope="module")
def jpeg_420_dir(tmp_path_factory):
    """Frames of exactly 224x224 at q75 and q95: PIL writes them 4:2:0."""
    d = tmp_path_factory.mktemp("jpegs420")
    i = 0
    for q in (75, 95):
        for img in _images():
            Image.fromarray(img).save(d / f"frame_{i:05d}.jpg", quality=q)
            i += 1
    return d


def _planes(size, frames=4, seed=0):
    """Seeded planes with a frame of zeros and one of 255s, so the red and
    blue terms leave [0, 255] and the clip is reached at both ends."""
    rng = np.random.RandomState(seed)
    planes = rng.randint(0, 256, (frames, yuv420.packed_plane_len(size)), dtype=np.uint8)
    planes[0], planes[1] = 0, 255
    return planes


@pytest.mark.parametrize("size", [224, 223, 17])
def test_conversion_is_bit_equal_to_jax(size):
    """Exact: the port's int32 arithmetic is libjpeg's, as JAX's is."""
    planes = _planes(size, seed=size)
    want = np.asarray(jyuv.yuv420_packed_to_rgb_chw(jnp.asarray(planes), size))
    got = yuv420.yuv420_packed_to_rgb_chw(torch.from_numpy(planes), size)
    assert got.dtype == torch.uint8 and got.shape == (4, 3, size, size)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(yuv420.yuv420_packed_to_rgb_chw_np(planes, size), want)
    assert (want == 0).any() and (want == 255).any()     # the clip is exercised
    assert yuv420.packed_plane_len(size) == jyuv.packed_plane_len(size)


@pytest.mark.parametrize("size", [224, 17])
def test_fancy_upsample_is_bit_equal_to_jax(size):
    cs = (size + 1) // 2
    c = np.random.RandomState(size).randint(0, 256, (2, cs, cs)).astype(np.int32)
    want = np.asarray(jyuv._fancy_upsample_h2v2(jnp.asarray(c), size, size))
    got = yuv420._fancy_upsample_h2v2(torch.from_numpy(c), size, size)
    np.testing.assert_array_equal(got.numpy(), want)


def test_whole_wire_is_bit_equal_to_pil(native, jpeg_420_dir):
    """The port's loader stops at the planes and its conversion finishes the
    decode: the same bytes as PIL's full decode (exact)."""
    paths = sorted(jpeg_420_dir.glob("frame_*.jpg"))
    packed = loader.load_frames_native_yuv420(paths, 224)
    assert packed is not None and packed.shape == (len(paths), yuv420.packed_plane_len(224))
    assert (loader.last_backend, loader.last_error) == ("native-yuv420", None)
    want = np.stack([frame_loader.load_image_u8(p, 224) for p in paths])
    np.testing.assert_array_equal(yuv420.yuv420_packed_to_rgb_chw_np(packed, 224), want)


@pytest.mark.parametrize("case", ["444", "wrong_size", "not_a_jpeg"])
def test_loader_refuses_what_the_wire_does_not_take(native, tmp_path, case):
    """4:4:4, a frame not at the model's size, a file that is no JPEG: None,
    and ``last_backend``/``last_error`` say why."""
    rng = np.random.RandomState(0)
    path = tmp_path / "frame_00000.jpg"
    if case == "444":
        Image.fromarray(rng.randint(0, 255, (224, 224, 3), np.uint8)).save(
            path, quality=95, subsampling=0)
    elif case == "wrong_size":
        Image.fromarray(rng.randint(0, 255, (120, 160, 3), np.uint8)).save(path, quality=95)
    else:
        path.write_bytes(b"not a jpeg")
    assert loader.load_frames_native_yuv420([path], 224) is None
    assert loader.last_backend == "rgb-fallback"
    reason = "decode failed" if case == "not_a_jpeg" else "unsupported"
    assert loader.last_error.startswith(reason) and str(path) in loader.last_error


def test_load_video_packed_formats(native, jpeg_420_dir, tmp_path):
    kind, arr = frame_loader.load_video_packed(jpeg_420_dir, num_frames=4, image_size=224)
    assert kind == "yuv420" and arr.shape == (4, yuv420.packed_plane_len(224))
    ref = frame_loader.load_video_array_u8(jpeg_420_dir, num_frames=4, image_size=224)[0]
    np.testing.assert_array_equal(yuv420.yuv420_packed_to_rgb_chw_np(arr, 224), ref)
    # frames not at 224: the whole video falls back to RGB
    d = tmp_path / "small"
    d.mkdir()
    rng = np.random.RandomState(1)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (64, 80, 3), np.uint8)).save(
            d / f"frame_{i:05d}.jpg", quality=95)
    kind, arr = frame_loader.load_video_packed(d, num_frames=3, image_size=224)
    assert kind == "rgb" and arr.shape == (1, 3, 3, 224, 224)
    # the wire refused: RGB as well
    kind, arr = frame_loader.load_video_packed(jpeg_420_dir, num_frames=4, image_size=224,
                                               allow_yuv420=False)
    assert kind == "rgb" and arr.shape == (1, 4, 3, 224, 224)


def test_load_video_packed_pads_short_videos(native, jpeg_420_dir):
    kind, arr = frame_loader.load_video_packed(jpeg_420_dir, num_frames=16, image_size=224)
    assert kind == "yuv420" and arr.shape == (16, yuv420.packed_plane_len(224))
    np.testing.assert_array_equal(arr[10], arr[9])      # the last real frame repeats
    np.testing.assert_array_equal(arr[15], arr[9])


def test_encode_video_takes_packed_planes(tiny_cfg):
    """[B,T,plane_len] planes: the embedding of their RGB (exact, the same
    pixels) and the JAX package's on the same planes (2e-6, f32)."""
    size = 32
    jcfg = dataclasses.replace(tiny_cfg, vit=dataclasses.replace(tiny_cfg.vit, image_size=size))
    jparams = jcm.init_caption_model(jax.random.PRNGKey(3), jcfg)
    cfg = port_cfg(jcfg)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    planes = _planes(size, frames=6, seed=9).reshape(2, 3, -1)
    rgb = yuv420.yuv420_packed_to_rgb_chw_np(planes.reshape(6, -1), size).reshape(
        2, 3, 3, size, size)
    got = cm.encode_video(params, torch.from_numpy(planes), cfg)
    assert got.shape == (2, cfg.video_dim)
    torch.testing.assert_close(got, cm.encode_video(params, torch.from_numpy(rgb), cfg),
                               rtol=0, atol=0)
    want = np.asarray(jcm.encode_video(jparams, jnp.asarray(planes), jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
