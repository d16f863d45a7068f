"""PyTorch port of the int8 path vs catears_tpu/am/quant.py.

The JAX matmul_s8 runs its Pallas kernel in interpret mode on the CPU.
Tolerances: quantize and quantize_static give equal int8 values, scale and
zero point; matmul_s8 / matmul_s8_ref are exact int32, also through the
kernel's transposed, K-padded weight; qmatmul (with its bias) agrees to
rtol 1e-6 (the epilogue's float ops may round differently under XLA's
fusion); the int8 layer stack has max error < 1% of the output range (a
one-step rounding flip in one layer moves the next layer's quantization).
Calibration runs the float stack, whose float32 matmuls sum in another
order than XLA's: ranges and coverage agree exactly on the first linear
(its input is the features) and within 1e-5 relative after it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import range_error, to_np
from catears_tpu.am import nnet as jnn
from catears_tpu.am import quant as jq
from catears_tpu.tools.toy import make_toy_nnet
from catears_tpu_torch.am import nnet as tnn
from catears_tpu_torch.am import quant as tq


@pytest.mark.parametrize("shape,scale,offset", [
    ((64, 48), 3.0, 0.0), ((30, 120), 1.0, 2.0), ((5, 7), 0.0, 2.5),
    ((9, 4), 0.0, -1.5), ((6, 6), 0.0, 0.0)])
def test_quantize_equal(shape, scale, offset):
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * scale + offset).astype(np.float32)
    ref = jq.quantize(jnp.asarray(x))
    got = tq.quantize(torch.from_numpy(x))
    assert np.array_equal(np.asarray(ref.values), got.values.numpy())
    assert np.float32(ref.scale) == got.scale.numpy()
    assert int(ref.zero_point) == int(got.zero_point)


def test_quantize_is_per_utterance():
    """[B, M, K] activations: one scale / zero point per utterance."""
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 10, 12) * np.array([1, 5, 20])[:, None, None]
         ).astype(np.float32)
    got = tq.quantize(torch.from_numpy(x))
    for u in range(3):
        ref = jq.quantize(jnp.asarray(x[u]))
        assert np.array_equal(np.asarray(ref.values), got.values[u].numpy())
        assert np.float32(ref.scale) == got.scale[u].numpy()
        assert int(ref.zero_point) == int(got.zero_point[u])


@pytest.mark.parametrize("m,k,n", [(37, 7, 5), (300, 130, 100),
                                   (64, 256, 72), (1, 1, 1)])
def test_matmul_s8_ref_equals_pallas(m, k, n):
    rng = np.random.RandomState(m + k + n)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    b = rng.randint(-128, 128, (k, n)).astype(np.int8)
    ref = np.asarray(jq.matmul_s8(jnp.asarray(a), jnp.asarray(b),
                                  interpret=True))
    got = tq.matmul_s8_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.int32 and np.array_equal(ref, got)
    # The wrapper takes the plain version for CPU tensors, and counts no
    # kernel launch.
    before = tq.matmul_s8.launches
    batched = tq.matmul_s8(torch.from_numpy(np.stack([a, a])),
                           torch.from_numpy(b)).numpy()
    assert np.array_equal(batched[1], ref)
    assert tq.matmul_s8.launches == before


def test_matmul_s8_rejects_bad_operands():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        tq.matmul_s8(a.float(), torch.zeros((8, 2), dtype=torch.int8))
    with pytest.raises(ValueError):
        tq.matmul_s8(a, torch.zeros((7, 2), dtype=torch.int8))
    with pytest.raises(ValueError):
        tq.matmul_s8(a[None, None], torch.zeros((8, 2), dtype=torch.int8))


@pytest.mark.parametrize("shape", [(8, 16, 8), (129, 65, 257)])
def test_qmatmul_matches_jax(shape):
    m, k, n = shape
    rng = np.random.RandomState(sum(shape))
    a = rng.randn(m, k).astype(np.float32)
    b = (rng.randn(k, n).astype(np.float32) * 2 + 0.5)
    ref = np.asarray(jq.qmatmul(jq.quantize(jnp.asarray(a)),
                                jq.quantize(jnp.asarray(b)), interpret=True))
    got = tq.qmatmul(tq.quantize(torch.from_numpy(a)),
                     tq.quantize(torch.from_numpy(b))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(
        ref).max())


@pytest.mark.parametrize("shape", [(8, 16, 8), (129, 65, 257)])
def test_qmatmul_bias_matches_jax(shape):
    """qmatmul(..., bias=) on the CPU is qmatmul(...) + b exactly, and
    matches JAX's qmatmul(...) + b to test_qmatmul_matches_jax's
    tolerance."""
    m, k, n = shape
    rng = np.random.RandomState(sum(shape) + 1)
    a = rng.randn(m, k).astype(np.float32)
    b = (rng.randn(k, n).astype(np.float32) * 2 + 0.5)
    bias = (rng.randn(n) * 0.1).astype(np.float32)
    jaq, jbq = jq.quantize(jnp.asarray(a)), jq.quantize(jnp.asarray(b))
    ref = np.asarray(jq.qmatmul(jaq, jbq, interpret=True) + jnp.asarray(bias))
    aq, bq = tq.quantize(torch.from_numpy(a)), tq.quantize(torch.from_numpy(b))
    got = tq.qmatmul(aq, bq, bias=torch.from_numpy(bias))
    assert torch.equal(got, tq.qmatmul(aq, bq) + torch.from_numpy(bias))
    assert torch.equal(got, tq.qmatmul_ref(aq, bq, bias=torch.from_numpy(bias)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("k,n", [(7, 5), (120, 64), (128, 33), (130, 17)])
def test_transposed_padded_weight_layout(k, n):
    """Wt [N, Kp]: W transposed, K zero-padded to a multiple of 16; the pad
    leaves the int8 dot, and so qmatmul, unchanged."""
    rng = np.random.RandomState(k * n)
    w = rng.randint(-128, 128, (k, n)).astype(np.int8)
    a = rng.randint(-128, 128, (2, 9, k)).astype(np.int8)
    bt = tq.transpose_pad(torch.from_numpy(w))
    kp = tq.padded_k(k)
    assert kp % 16 == 0 and 0 <= kp - k < 16
    assert bt.shape == (n, kp) and bt.dtype == torch.int8 and bt.is_contiguous()
    assert np.array_equal(bt[:, :k].numpy(), w.T) and not bt[:, k:].any()
    a_p = torch.nn.functional.pad(torch.from_numpy(a), (0, kp - k))
    ref = tq.matmul_s8_ref(torch.from_numpy(a), torch.from_numpy(w))
    assert torch.equal(tq.matmul_s8_ref(a_p, bt.t().contiguous()), ref)
    # The kernel's operands as the wrappers prepare them, also for a
    # contiguous view that does not start on a 16-byte boundary.
    buf = torch.zeros(1 + a.size, dtype=torch.int8)
    view = buf[1:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    for a3 in (torch.from_numpy(a), view):
        a2, bt2, kp2 = tq._launch_operands(a3, torch.from_numpy(w), None)
        assert kp2 == kp and torch.equal(bt2, bt)
        assert a2.shape == (18, kp) and a2.data_ptr() % 16 == 0
        assert torch.equal(tq.matmul_s8_ref(a2, bt2.t().contiguous()),
                           ref.reshape(18, n))
    aq = tq.quantize(torch.from_numpy(rng.randn(2, 9, k).astype(np.float32)))
    wq = tq.quantize(torch.from_numpy(rng.randn(k, n).astype(np.float32)))
    assert torch.equal(tq.qmatmul(aq, wq, bt=tq.transpose_pad(wq.values)),
                       tq.qmatmul_ref(aq, wq))


def test_transposed_weight_buffer_built_by_both_constructors():
    rng = np.random.RandomState(4)
    nnet_def, params = jnn.build_nnet(make_toy_nnet(rng, hidden=48,
                                                    num_pdfs=40))
    own = tq.quantize_params(nnet_def, [{k: to_np(v) for k, v in p.items()}
                                        for p in params])
    carried = tq.from_jax_qparams(nnet_def,
                                  jq.quantize_params(nnet_def, params))
    linears = [i for i, layer in enumerate(nnet_def) if layer[0] == "linear"]
    assert len(linears) == 3
    for i in linears:
        for net in (own, carried):
            p = net.params(i)
            assert torch.equal(p["wqt_values"],
                               tq.transpose_pad(p["wq_values"]))
        assert torch.equal(own.params(i)["wqt_values"],
                           carried.params(i)["wqt_values"])


def test_nnet_forward_quant_matches_jax():
    rng = np.random.RandomState(3)
    spec = make_toy_nnet(rng, hidden=64, num_pdfs=32)
    nnet_def, params = jnn.build_nnet(spec)
    jqp = jq.quantize_params(nnet_def, params)
    x = rng.randn(2, 24, 40).astype(np.float32)
    # The port's own weight quantization equals the JAX one.
    tqnet = tq.quantize_params(nnet_def, [{k: to_np(v) for k, v in p.items()}
                                          for p in params])
    carried = tq.from_jax_qparams(nnet_def, jqp)
    for (n1, a), (n2, b) in zip(sorted(tqnet.named_buffers()),
                                sorted(carried.named_buffers())):
        assert n1 == n2 and torch.equal(a, b), n1
    got = tq.nnet_forward_quant(tqnet, torch.from_numpy(x)).numpy()
    for u in range(2):
        ref = np.asarray(jq.nnet_forward_quant(nnet_def, jqp,
                                               jnp.asarray(x[u])))
        assert got[u].shape == ref.shape
        assert range_error(ref, got[u]) < 0.01


@pytest.mark.parametrize("lo,hi", [(-1.5, 2.25), (0.1, 0.7), (-3.0, -0.5),
                                   (0.0, 0.0), (-2.0, -2.0), (1.7, 1.7),
                                   (-0.3333, 5.123456789)])
def test_quantize_static_equal(lo, hi):
    """Equal to JAX's, with the range given as Python floats as
    calibrate_ranges stores it (degenerate and one-sided ranges too)."""
    rng = np.random.RandomState(int(abs(lo * 100 + hi * 10)))
    x = (rng.randn(3, 17, 23) * 2).astype(np.float32)
    got = tq.quantize_static(torch.from_numpy(x), torch.tensor(lo),
                             torch.tensor(hi))
    for u in range(3):
        ref = jq.quantize_static(jnp.asarray(x[u]), lo, hi)
        assert np.array_equal(np.asarray(ref.values), got.values[u].numpy())
        assert np.asarray(ref.scale).tobytes() == got.scale.numpy().tobytes()
        assert int(ref.zero_point) == int(got.zero_point)


def _calib_setup(seed=3):
    rng = np.random.RandomState(seed)
    nnet_def, params = jnn.build_nnet(make_toy_nnet(rng, hidden=64,
                                                    num_pdfs=32))
    np_params = [{k: to_np(v) for k, v in p.items()} for p in params]
    feats = [rng.randn(t, 40).astype(np.float32) * s
             for t, s in ((24, 1.0), (31, 2.0), (17, 0.5))]
    return nnet_def, params, np_params, feats


def _ranges(qparams, key):
    return [p[key] for p in qparams if key in p]


@pytest.mark.parametrize("guard", [False, True])
def test_calibrate_ranges_and_coverage_match_jax(guard):
    nnet_def, params, np_params, feats = _calib_setup()
    jqp = jq.quantize_params(nnet_def, params)
    jq.calibrate_ranges(nnet_def, params, jqp,
                        [jnp.asarray(f) for f in feats[:2]], guard=guard)
    tqnet = tq.quantize_params(nnet_def, np_params)
    fnet = tnn.from_jax_params(nnet_def, params)
    tq.calibrate_ranges(nnet_def, fnet, tqnet,
                        [torch.from_numpy(f) for f in feats[:2]], guard=guard)
    key, other = ("grng", "rng") if guard else ("rng", "grng")
    ref = np.asarray(_ranges(jqp, key), np.float32)
    got = np.stack([tqnet.params(i)[key].numpy()
                    for i, layer in enumerate(nnet_def)
                    if layer[0] == "linear"])
    assert got.shape == ref.shape == (3, 2)
    assert not _ranges(jqp, other)
    assert all(other not in tqnet.params(i) for i in range(len(nnet_def)))
    assert np.array_equal(ref[0], got[0])
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # Recalibrating with the other key replaces the range.
    tq.calibrate_ranges(nnet_def, fnet, tqnet, torch.from_numpy(feats[0]),
                        guard=not guard)
    assert all(key not in tqnet.params(i) for i in range(len(nnet_def)))
    tq.calibrate_ranges(nnet_def, fnet, tqnet,
                        [torch.from_numpy(f) for f in feats[:2]], guard=guard)

    held_out = feats[2:] + [feats[1] * 3]
    ref_cov = jq.calibration_coverage(nnet_def, params, jqp,
                                      [jnp.asarray(f) for f in held_out])
    got_cov = tq.calibration_coverage(nnet_def, fnet, tqnet,
                                      [torch.from_numpy(f) for f in held_out])
    assert len(got_cov) == len(ref_cov) == 3
    assert got_cov[0] == ref_cov[0] < 1.0
    np.testing.assert_allclose(got_cov, ref_cov, rtol=1e-5)


@pytest.mark.parametrize("key", ["rng", "grng"])
def test_nnet_forward_quant_calibrated_matches_jax(key):
    """A ragged batch (utterances zero-padded to one length) through the
    static (`rng`: one scale for every utterance) and guarded (`grng`: the
    range widened per utterance) int8 stack, with JAX's ranges carried
    across: within 1% of range of JAX run on each utterance, and the first
    linear's quantized input equal to JAX's."""
    nnet_def, params, _, feats = _calib_setup(5)
    jqp = jq.quantize_params(nnet_def, params)
    # Calibrate on a narrow set so the batch exceeds the range: `rng`
    # saturates and `grng` widens.
    jq.calibrate_ranges(nnet_def, params, jqp, jnp.asarray(feats[2]),
                        guard=key == "grng")
    carried = tq.from_jax_qparams(nnet_def, jqp)
    assert all(key in carried.params(i) for i, layer in enumerate(nnet_def)
               if layer[0] == "linear")
    t = max(f.shape[0] for f in feats)
    x = np.zeros((len(feats), t, 40), np.float32)
    for u, f in enumerate(feats):
        x[u, :f.shape[0]] = f
    got = tq.nnet_forward_quant(carried, torch.from_numpy(x)).numpy()
    # The layers before the first linear (splice) are exact in both.
    i0 = [layer[0] for layer in nnet_def].index("linear")
    fnet = tnn.from_jax_params(nnet_def, params)
    xt = torch.from_numpy(x)
    for i in range(i0):
        xt = fnet.forward_layer(i, xt)
    lo, hi = jqp[i0][key]
    first = tq._quantize_input(xt, carried.params(i0))
    for u in range(len(feats)):
        ref = np.asarray(jq.nnet_forward_quant(nnet_def, jqp,
                                               jnp.asarray(x[u])))
        assert got[u].shape == ref.shape
        assert range_error(ref, got[u]) < 0.01
        xu = jnn.nnet_forward(nnet_def[:i0], params[:i0], jnp.asarray(x[u]))
        if key == "grng":
            ref_q = jq.quantize_static(xu, jnp.minimum(jnp.min(xu), lo),
                                       jnp.maximum(jnp.max(xu), hi))
        else:
            ref_q = jq.quantize_static(xu, lo, hi)
        assert np.array_equal(np.asarray(ref_q.values),
                              first.values[u].numpy())
    if key == "grng":
        assert len(set(first.scale.tolist())) == len(feats)
    else:
        assert first.scale.dim() == 0
