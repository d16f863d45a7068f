"""PyTorch port of the acoustic model and the batched AM path vs JAX.

Tolerances: the float layers and the float `batched_logp` within 1e-4
(float32 matmuls summed in another order); the quantized `batched_logp`
within 1% of the output range (tests/test_quant.py's criterion: a one-step
rounding flip in one layer moves the next layer's quantization).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, range_error, to_np
from catears_tpu.am import model as jmodel
from catears_tpu.am import nnet as jnn
from catears_tpu.io.config import Configuration
from catears_tpu.runtime import batch as jbatch
from catears_tpu.tools.toy import make_toy_nnet, write_toy_model
from catears_tpu_torch.am import model as tmodel
from catears_tpu_torch.am import nnet as tnn
from catears_tpu_torch.io.config import Configuration as TConfiguration
from catears_tpu_torch.runtime import batch as tbatch

ATOL = 1e-4


@pytest.mark.parametrize("indices", [(-1, 0, 1), (-2, 0, 3), (0,)])
def test_splice_exact(indices):
    x = np.random.RandomState(0).randn(7, 5).astype(np.float32)
    ref = np.asarray(jnn.splice(jnp.asarray(x), indices))
    got = tnn.splice(torch.from_numpy(x), indices).numpy()
    batched = tnn.splice(torch.from_numpy(np.stack([x, x])), indices).numpy()
    assert np.array_equal(ref, got) and np.array_equal(batched[1], ref)


@pytest.mark.parametrize("t,left,right", [(10, 2, 3), (4, 2, 2)])
def test_narrow_exact(t, left, right):
    x = np.arange(t * 3, dtype=np.float32).reshape(t, 3)
    ref = np.asarray(jnn.narrow(jnp.asarray(x), left, right))
    assert np.array_equal(ref, tnn.narrow(torch.from_numpy(x), left,
                                          right).numpy())


def test_layer_kinds_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(6, 8).astype(np.float32)
    scale = rng.rand(8).astype(np.float32)
    offset = rng.randn(8).astype(np.float32)
    p = {"scale": scale, "offset": offset}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for kind in ("relu", "normalize", "softmax", "logsoftmax", "batchnorm"):
        ref = np.asarray(jnn.nnet_forward(((kind,),), [p], jnp.asarray(x)))
        got = tnn.apply_layer(kind, (kind,), torch.from_numpy(x), tp).numpy()
        assert np.abs(ref - got).max() < ATOL, kind


def test_from_jax_params_and_forward():
    rng = np.random.RandomState(2)
    nnet_def, params = jnn.build_nnet(make_toy_nnet(rng, hidden=32,
                                                    num_pdfs=24))
    net = tnn.from_jax_params(nnet_def, params)
    for i, p in enumerate(params):
        for name, value in p.items():
            assert np.array_equal(np.asarray(value),
                                  net.params(i)[name].numpy())
    x = rng.randn(30, 40).astype(np.float32)
    ref = np.asarray(jnn.nnet_forward(nnet_def, params, jnp.asarray(x)))
    got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and np.abs(ref - got).max() < ATOL


@pytest.fixture(scope="module")
def toy_conf(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_am")
    conf = write_toy_model(str(d), rng=np.random.RandomState(4),
                           hidden=32, num_pdfs=24)
    qconf = str(d / "toyq.conf")
    with open(conf) as src, open(qconf, "w") as dst:
        dst.write(src.read() + "quantized = true\n")
    return conf, qconf


def _waves():
    rng = np.random.RandomState(9)
    return [(rng.randn(n) * 1500).astype(np.float32)
            for n in (5200, 3100, 8000)]


@pytest.mark.parametrize("quantized", [False, True])
def test_batched_logp_matches_jax(toy_conf, quantized):
    path = toy_conf[1] if quantized else toy_conf[0]
    jam = jmodel.AcousticModel.read(Configuration.read(path))
    tam = tmodel.AcousticModel.read(TConfiguration.read(path), device=CPU)
    assert tam.quantized == jam.quantized == quantized
    assert np.array_equal(np.asarray(jam.log_prior), tam.log_prior.numpy())
    waves = _waves()
    ref, ref_len = jbatch.batched_logp(jam, waves)
    got, got_len = tbatch.batched_logp(tam, waves)
    assert got_len == ref_len
    ref, got = np.asarray(ref), to_np(got)
    assert got.shape == ref.shape
    for u, t in enumerate(got_len):  # frames past each length are padding
        if quantized:
            assert range_error(ref[u, :t], got[u, :t]) < 0.01
        else:
            assert np.abs(ref[u, :t] - got[u, :t]).max() < ATOL


def test_forward_padded_single_utterance(toy_conf):
    jam = jmodel.AcousticModel.read(Configuration.read(toy_conf[0]))
    tam = tmodel.AcousticModel.read(TConfiguration.read(toy_conf[0]),
                                    device=CPU)
    feats = np.random.RandomState(5).randn(20, 40).astype(np.float32)
    padded = jam.pad_context(feats)
    ref = np.asarray(jam.forward_padded(jnp.asarray(padded)))
    got = tam.forward_padded(torch.from_numpy(padded)).detach().numpy()
    assert got.shape == (20, 24) and np.abs(ref - got).max() < ATOL


@pytest.mark.parametrize("guard", [False, True])
def test_calibrated_batched_logp_matches_jax(toy_conf, data_dir, guard):
    """AcousticModel.calibrate on one utterance's context-padded fbank rows
    (the same numpy rows for both), then batched_logp of ragged waves."""
    import os

    from catears_tpu.frontend.fbank import fbank_from_wave, num_frames
    from catears_tpu.io.wav import read_16k_pcm

    jam = jmodel.AcousticModel.read(Configuration.read(toy_conf[1]))
    tam = tmodel.AcousticModel.read(TConfiguration.read(toy_conf[1]),
                                    device=CPU)
    cal = read_16k_pcm(os.path.join(data_dir, "en-us-cat.wav"))
    padded = jam.pad_context(np.asarray(fbank_from_wave(
        jnp.asarray(cal), num_frames(cal.shape[0]))))
    jam.calibrate(padded, guard=guard)
    tam.calibrate(padded, guard=guard)
    key = "grng" if guard else "rng"
    linears = [i for i, layer in enumerate(tam.nnet_def)
               if layer[0] == "linear"]
    assert all(key in tam.nnet.params(i) for i in linears)
    first = linears[0]
    assert np.array_equal(np.asarray(jam.params[first][key], np.float32),
                          tam.nnet.params(first)[key].numpy())
    waves = _waves()
    ref, _ = jbatch.batched_logp(jam, waves)
    got, lengths = tbatch.batched_logp(tam, waves)
    ref, got = np.asarray(ref), to_np(got)
    for u, t in enumerate(lengths):
        assert range_error(ref[u, :t], got[u, :t]) < 0.01
    # Calibration is a no-op on the float AM.
    fam = tmodel.AcousticModel.read(TConfiguration.read(toy_conf[0]),
                                    device=CPU)
    fam.calibrate(padded)
    assert not any("rng" in n for n, _ in fam.named_buffers())
