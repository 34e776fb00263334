"""BS-RoFormer's rotary embedding of the queries and keys from the QKV
projection's output (``RotaryEmbedding.rotate_qk``).

On the CPU the entry point is ``rotate`` on the projection's q and k views,
bit for bit, and an attention layer through it gives what the layer gave with
q, k and v permuted from the projection and ``rotate`` on each, at the
published heads (8 x 64) and both of the cell's lengths (146 frames, 62
bands). On the card (``cuda`` marker, skipped without one) the kernel of
``csrc/rope_qk.cu`` against ``rotate`` on the same card tensors, bit for
bit, at both lengths and at a token count that is not a multiple of a
block's; the wrapper raising on what the kernel does not take; one launch an
attention layer, 24 a forward at the published depth. The file imports no
JAX, so it runs on the card:

    python -m pytest tests/test_torch_rope_qk.py --noconftest -q
"""

import pytest
import torch
import torch.nn.functional as F

from musicfpaugment_torch.models import BSRoformer
from musicfpaugment_torch.models import bs_roformer as R
from torch_threads import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

HEADS, DIM_HEAD = 8, 64
# the cell's two lengths: 146 frames of an 8 s query in the time layers, 62
# bands in the band layers
LENGTHS = [146, 62]
# sequences: 7 x 146 and 7 x 62 tokens are 2 past a multiple of the
# kernel's four tokens a block
SEQUENCES = 7
PUBLISHED = dict(dim=384, depth=12, time_transformer_depth=1, freq_transformer_depth=1,
                 stft_hop_length=441)


def _qkv(S: int, n: int, device="cpu", dtype=torch.float32, heads=HEADS, dim_head=DIM_HEAD):
    gen = torch.Generator().manual_seed(S * 1000 + n)
    return torch.randn(S, n, 3 * heads * dim_head, generator=gen, dtype=dtype).to(device)


def _plain(rope: R.RotaryEmbedding, qkv: torch.Tensor, heads: int = HEADS):
    """q and k as the attention layer took them before the entry point:
    permuted views of the projection, each through ``rotate``."""
    S, n, _ = qkv.shape
    q, k, _ = qkv.view(S, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    return rope.rotate(q), rope.rotate(k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("n", LENGTHS)
def test_rotate_qk_on_the_cpu_is_rotate_of_q_and_k(n, dtype):
    rope = R.RotaryEmbedding(DIM_HEAD)
    qkv = _qkv(SEQUENCES, n, dtype=dtype)
    launches = R.LAUNCHES["rope_qk"]
    q, k = rope.rotate_qk(qkv, HEADS)
    want_q, want_k = _plain(rope, qkv)
    assert q.shape == k.shape == (SEQUENCES, HEADS, n, DIM_HEAD)
    assert torch.equal(q, want_q) and torch.equal(k, want_k)
    assert not torch.equal(q, qkv.view(SEQUENCES, n, 3, HEADS, -1)[:, :, 0].transpose(1, 2))
    assert R.LAUNCHES["rope_qk"] == launches


@pytest.mark.parametrize("n", LENGTHS)
def test_attention_layer_is_its_plain_formula(n):
    """The layer's output through ``rotate_qk`` and its v view equals the
    published forward written out: q, k, v permuted from the projection,
    RoPE on q and k, attention, the heads merged, the output projection."""
    torch.manual_seed(n)
    rope = R.RotaryEmbedding(DIM_HEAD)
    attn = R.Attention(96, HEADS, DIM_HEAD, rope).eval()
    x = torch.randn(3, n, 96)
    with torch.no_grad():
        got = attn(x)
        qkv = attn.to_qkv(attn.norm(x))
        q, k, v = qkv.view(3, n, 3, HEADS, -1).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(rope.rotate(q), rope.rotate(k), v)
        want = attn.to_out(out.transpose(1, 2).reshape(3, n, -1))
    assert torch.equal(got, want)


def test_the_kernel_wrapper_takes_cuda_tensors_only():
    rope = R.RotaryEmbedding(DIM_HEAD)
    qkv = _qkv(2, 62)
    with pytest.raises(ValueError, match="CUDA tensor"):
        R.rope_qk_cuda(qkv, *rope.cos_sin(62, qkv), HEADS)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the rotary kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS)
def test_kernel_is_rotate_bit_for_bit_on_the_card(cuda_device, n):
    rope = R.RotaryEmbedding(DIM_HEAD)
    qkv = _qkv(SEQUENCES, n, cuda_device)
    launches = R.LAUNCHES["rope_qk"]
    q, k = rope.rotate_qk(qkv, HEADS)
    want_q, want_k = _plain(rope, qkv)
    torch.cuda.synchronize()
    assert R.LAUNCHES["rope_qk"] == launches + 1
    assert q.shape == k.shape == (SEQUENCES, HEADS, n, DIM_HEAD)
    assert q.is_contiguous() and k.is_contiguous()
    assert int((q != want_q).sum()) == 0 and int((k != want_k).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["not_contiguous", "float64", "head_width_32"])
def test_kernel_wrapper_raises_on_what_it_does_not_take(cuda_device, case):
    rope = R.RotaryEmbedding(DIM_HEAD)
    if case == "not_contiguous":
        qkv = _qkv(SEQUENCES, 62, cuda_device).transpose(0, 1).contiguous().transpose(0, 1)
        match = "contiguous"
    elif case == "float64":
        qkv = _qkv(SEQUENCES, 62, cuda_device, dtype=torch.float64)
        match = "float32"
    else:
        qkv = _qkv(SEQUENCES, 62, cuda_device, dim_head=32)
        match = "width 64"
    launches = R.LAUNCHES["rope_qk"]
    with pytest.raises(ValueError, match=match):
        rope.rotate_qk(qkv, HEADS)
    assert R.LAUNCHES["rope_qk"] == launches


@pytest.mark.cuda
def test_one_launch_an_attention_layer_at_the_published_depth(cuda_device):
    """12 axial blocks of one time and one band layer: 24 launches a
    forward; the output equal, bit for bit, to the same forward with q and
    k rotated by the plain version on the card."""
    torch.manual_seed(0)
    model = BSRoformer(**PUBLISHED).eval().to(cuda_device)
    x = 0.3 * torch.randn(1, 8000, device=cuda_device)
    launches = R.LAUNCHES["rope_qk"]
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    assert R.LAUNCHES["rope_qk"] == launches + 24
    ropes = {id(m.rotary_embed): m.rotary_embed for m in model.modules()
             if isinstance(m, R.Attention)}
    assert len(ropes) == 2
    for rope in ropes.values():
        rope.rotate_qk = lambda qkv, heads, rope=rope: _plain(rope, qkv, heads)
    with torch.no_grad():
        want = model(x)
    assert R.LAUNCHES["rope_qk"] == launches + 24
    assert torch.equal(got, want)
