"""The port's synthetic data: ``TokenStream`` (LM batches with a planted
bigram, one token per codebook for MusicGen) and ``vit_patch_embeds`` (the
prefix stub of InternVL2 and Llama-4).  JAX's random bits cannot be
reproduced, so these hold the port to the JAX package's shapes, ranges,
dtypes and planted rule, not its bits; the parity tests feed numpy
prompts and prefixes to both packages."""
import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as jdata
from repro_torch.data import synthetic as tdata


@pytest.mark.parametrize("codebooks", [1, 4])
def test_token_stream_shapes_and_range_match_jax(codebooks):
    js = jdata.TokenStream(512, 33, 3, num_codebooks=codebooks, seed=5)
    ts = tdata.TokenStream(512, 33, 3, num_codebooks=codebooks, seed=5)
    jt, jy = js.batch_at(2)
    tt, ty = ts.batch_at(2, device="cpu")
    for a, b in ((jt, tt), (jy, ty)):
        assert tuple(b.shape) == a.shape
        assert b.dtype == torch.int64
        assert 0 <= int(b.min()) and int(b.max()) < 512
    assert torch.equal(tt[:, 1:], ty[:, :-1])


@pytest.mark.parametrize("codebooks", [1, 4])
def test_token_stream_plants_the_bigram(codebooks):
    """A token is (b · 31 + 7) mod V with probability 1/2, b the uniform
    draw at the previous position, which is the previous token itself
    with probability 1/2: so about a quarter of the tokens follow their
    previous one by the rule, in both packages' streams (a uniform draw
    hits it 1 in V)."""
    v = 97
    rates = []
    for stream, kw in ((jdata.TokenStream(v, 400, 8, codebooks, seed=1), {}),
                       (tdata.TokenStream(v, 400, 8, codebooks, seed=1),
                        {"device": "cpu"})):
        toks = np.asarray(stream.batch_at(0, **kw)[0])
        rates.append(float(((toks[:, :-1] * 31 + 7) % v
                            == toks[:, 1:]).mean()))
    for rate in rates:
        assert 0.23 < rate < 0.29, rates


def test_token_stream_is_a_function_of_seed_and_step():
    ts = tdata.TokenStream(512, 16, 2, seed=3)
    a, _ = ts.batch_at(4, device="cpu")
    assert torch.equal(a, ts.batch_at(4, device="cpu")[0])
    assert not torch.equal(a, ts.batch_at(5, device="cpu")[0])
    other = tdata.TokenStream(512, 16, 2, seed=4)
    assert not torch.equal(a, other.batch_at(4, device="cpu")[0])


def test_vit_patch_embeds_match_jax_in_shape_and_scale():
    want = np.asarray(jdata.vit_patch_embeds(jax.random.PRNGKey(0), 4, 256,
                                             96))
    got = tdata.vit_patch_embeds(torch.Generator().manual_seed(0), 4, 256,
                                 96, device="cpu")
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert abs(float(got.std()) - 0.02) < 1e-3
    assert abs(float(want.std()) - 0.02) < 1e-3
    again = tdata.vit_patch_embeds(torch.Generator().manual_seed(0), 4, 256,
                                   96, device="cpu")
    assert torch.equal(got, again)


def test_entry_points_need_a_device_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.TokenStream(8, 4, 1).batch_at(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.vit_patch_embeds(torch.Generator(), 1, 2, 4)
