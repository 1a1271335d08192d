"""int8 serving weights in the port (``serving/quant.py`` and the engine's
``weight_dtype="int8"``) against the JAX package, on the CPU.

- payloads and scales against JAX's ``quantize_params``, bitwise (the
  chunk-scaled pair: absmax / 127 a chunk, round half to even, clip
  +-127), at chunk 256 and 64;
- ``dequantize_params``, and the engine's per-layer and per-row views of
  a leaf, equal to JAX's whole-leaf dequantization;
- ``quantized_nbytes`` equal to JAX's for f32, bf16 and int8;
- the twin of ``tests/test_serving_engine.py::
  test_int8_and_bf16_weight_parity`` on the port (slab and paged), and
  the port's int8 stream against the JAX int8 engine's.
"""
import numpy as np
import pytest
import torch

import jax

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu.serving import quant as JQ
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.serving import quant as TQ

EKW = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16), page_size=8)


@pytest.fixture(scope="module")
def tiny():
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    jp = JG.init_params(jax.random.PRNGKey(0), cfg_j)
    tp = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg_j, jp, cfg_t, tp


def _pairs(jtree, ttree, path=()):
    """(path, JAX leaf, port leaf) over the two storage trees."""
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _pairs(jtree[k], ttree[k], path + (k,))
    else:
        yield path, jtree, ttree


@pytest.mark.parametrize("chunk", [256, 64])
def test_quantize_params_match_jax(tiny, chunk):
    _, jp, _, tp = tiny
    jq = JQ.quantize_params(jp, "int8", chunk)
    tq = TQ.quantize_params(tp, "int8", chunk)
    n = 0
    for path, j, t in _pairs(jq, tq):
        assert isinstance(t, TQ.QuantizedLeaf), path
        assert (t.shape, t.pad, t.chunk) == (j.shape, j.pad, j.chunk), path
        np.testing.assert_array_equal(t.scales.numpy(),
                                      np.asarray(j.scales), err_msg=path)
        np.testing.assert_array_equal(t.payload.numpy(),
                                      np.asarray(j.payload), err_msg=path)
        assert t.payload.dtype == torch.int8
        n += 1
    assert n == 17


def test_quantize_chunked_rounds_half_to_even_and_clips():
    """Halfway quanta round to even, absmax lands on +-127, an all-zero
    chunk keeps scale 1 — on values where x / scale is exact."""
    x = torch.tensor([127.0, -127.0, 2.5, 3.5, -0.5, 1.5, 0.0, 10.0]
                     + [0.0] * 8)
    q, s = TQ.quantize_chunked(x, 8)
    assert s.tolist() == [1.0, 1.0]
    assert q.tolist()[:8] == [127, -127, 2, 4, 0, 2, 0, 10]
    back = TQ.dequantize_chunked(q, s, 8)
    assert back.tolist()[:2] == [127.0, -127.0]


@pytest.mark.parametrize("chunk", [256, 64])
def test_dequantize_params_match_jax(tiny, chunk):
    _, jp, _, tp = tiny
    jd = JQ.dequantize_params(JQ.quantize_params(jp, "int8", chunk))
    tq = TQ.quantize_params(tp, "int8", chunk)
    td = TQ.dequantize_params(tq)
    for path, j, t in _pairs(jd, td):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=path)
    # the engine's views: one layer of a stacked leaf (its chunks only),
    # and gathered embedding rows (D = 64: whole chunks at chunk 64)
    for name, leaf in tq["blocks"].items():
        for i in range(leaf.shape[0]):
            np.testing.assert_array_equal(
                leaf.layer(i).numpy(), np.asarray(jd["blocks"][name][i]))
    idx = torch.tensor([[3, 0, 255], [7, 7, 1]])
    np.testing.assert_array_equal(tq["wte"].rows(idx).numpy(),
                                  np.asarray(jd["wte"])[idx.numpy()])


@pytest.mark.parametrize("chunk", [256, 64])
def test_dequantize_into_the_compute_dtype_rounds_once(tiny, chunk):
    """The engine's int8 forward takes each matmul leaf as one product
    written in bf16: the float32 dequantization rounded once, bit for
    bit (what the reference's ``dequantize_params`` + ``.astype``
    gives)."""
    tq = TQ.quantize_params(tiny[3], "int8", chunk)
    for name, leaf in tq["blocks"].items():
        for i in range(leaf.shape[0]):
            assert torch.equal(leaf.layer(i, torch.bfloat16),
                               leaf.layer(i).to(torch.bfloat16)), name
    assert torch.equal(tq["lm_head"].dequantize(torch.bfloat16),
                       tq["lm_head"].dequantize().to(torch.bfloat16))


@pytest.mark.parametrize("wd", ["f32", "bf16", "int8"])
def test_quantized_nbytes_equal_jax(tiny, wd):
    _, jp, _, tp = tiny
    want = JQ.quantized_nbytes(JQ.quantize_params(jp, wd, 256))
    assert TQ.quantized_nbytes(TQ.quantize_params(tp, wd, 256)) == want
    cfg_t = tiny[2]
    eng = TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(weight_dtype=wd, **EKW),
                          device="cpu")
    assert eng.weight_nbytes == want


def _stream(eng, seq):
    slot, l0 = eng.start_sequence(seq[:1])
    ls = [l0]
    for t in seq[1:]:
        ls.append(eng.decode_step({slot: t})[slot])
    eng.free_sequence(slot)
    return np.stack(ls)


@pytest.fixture(scope="module")
def jax_int8_stream(tiny):
    cfg_j, jp, _, _ = tiny
    eng = JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(weight_dtype="int8",
                                                     **EKW))
    seq = np.random.RandomState(3).randint(0, cfg_j.vocab_size,
                                           size=16).tolist()
    return seq, _stream(eng, seq)


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_int8_and_bf16_weight_parity(tiny, jax_int8_stream, layout):
    _, _, cfg, tp = tiny

    def engine(**kw):
        return TS.DecodeEngine(tp, cfg, TS.EngineConfig(
            kv_layout=layout, **{**EKW, **kw}), device="cpu")

    f32, q8, b16 = engine(), engine(weight_dtype="int8"), \
        engine(weight_dtype="bf16")
    seq, jax_s8 = jax_int8_stream
    ref, s8, s16 = _stream(f32, seq), _stream(q8, seq), _stream(b16, seq)
    stats = TQ.logit_error_stats(ref, s8)
    assert stats["max_rel_err"] < TQ.INT8_LOGIT_TOL, stats
    assert stats["top1_agreement"] >= 0.95, stats
    ppl_ref = TQ.perplexity(ref[:-1], seq[1:])
    ppl_q = TQ.perplexity(s8[:-1], seq[1:])
    assert abs(ppl_q / ppl_ref - 1.0) < TQ.INT8_PPL_REL_TOL
    assert TQ.logit_error_stats(ref, s16)["max_rel_err"] < TQ.INT8_LOGIT_TOL
    assert q8.weight_nbytes < f32.weight_nbytes / 3.5
    # the same quantized weights as the JAX int8 engine: its stream
    np.testing.assert_allclose(s8, jax_s8, atol=1e-4, rtol=1e-4)
    assert (s8.argmax(-1) == jax_s8.argmax(-1)).all()
    # the card holds no float copy of an int8 engine's weights
    q8.drop_reference_params()
    with pytest.raises(RuntimeError, match="dropped"):
        q8.reference_logits(seq)
    assert not hasattr(q8, "layers")
