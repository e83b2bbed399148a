"""The port's CUDA kernels against their plain PyTorch versions on an NVIDIA
GPU, through the same checks chip_smoke.py runs
(video_caption_tpu_torch/ops/selfcheck.py). Every test here needs the card:
they carry the ``cuda`` marker and skip where torch.cuda.is_available() is
false. Run them on the GPU with

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""
import pytest
import torch

from video_caption_tpu_torch.ops import selfcheck

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _assert_ok(result):
    assert result.ok, result.as_dict()


@pytest.mark.parametrize("frames", [1, 16])
def test_encoder_attention_kernel(cuda, frames):
    _assert_ok(selfcheck.check_encoder_attention(frames, cuda))


def test_encoder_attention_kernel_odd_sequence(cuda):
    _assert_ok(selfcheck.check_encoder_attention(3, cuda, seq=13, heads=4))


@pytest.mark.parametrize("rows", [1, 8, 65])
def test_prefix_projector_kernel(cuda, rows):
    _assert_ok(selfcheck.check_prefix_projector(rows, cuda))


@pytest.mark.parametrize("rows", [1, 6, 9, 17])
def test_lm_head_kernel(cuda, rows):
    _assert_ok(selfcheck.check_lm_head(rows, cuda))


def test_lm_head_kernel_small_vocab(cuda):
    _assert_ok(selfcheck.check_lm_head(4, cuda, h=128, vocab=1337))


@pytest.mark.parametrize("videos,beams,steps,t", [(2, 3, 24, 0), (2, 3, 24, 23), (1, 4, 40, 17),
                                                  (3, 3, 6, 5)])
def test_beam_attention_kernel(cuda, videos, beams, steps, t):
    _assert_ok(selfcheck.check_beam_attention(videos, beams, 12, steps, t, cuda))


def test_kernel_launch_counters(cuda):
    from video_caption_tpu_torch.ops import encoder_attention as ea

    before = ea.launches
    selfcheck.check_encoder_attention(1, cuda)
    assert ea.launches > before


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from video_caption_tpu_torch.ops import encoder_attention as ea
    from video_caption_tpu_torch.ops import lm_head as lmh

    with pytest.raises(TypeError):
        ea.encoder_attention(torch.zeros(1, 5, 3 * 128, dtype=torch.float16, device=cuda), 2)
    with pytest.raises(ValueError):
        ea.encoder_attention(torch.zeros(1, 5, 3 * 96, device=cuda), 2)   # head dim 48
    with pytest.raises(ValueError):
        lmh.lm_head_stats(torch.zeros(2, 8, device=cuda), torch.zeros(8, 200, device=cuda), 200)
