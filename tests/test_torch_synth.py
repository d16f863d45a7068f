"""The port's synthetic-training tool (`catears_tpu_torch.tools.synth`) vs
the JAX package's (tests/test_synth.py's counterparts).

On the CPU, at tests/test_synth.py's size (a 60-word trie of 20 phones x 1
variant, TDNN-64 x 2, 24 utterances of up to 3 s):
- Synthesizer waves, targets and words bit-equal to JAX's for the same
  seeds; fbank_labels and empirical_prior equal;
- write_trained_model's files byte-equal to JAX's;
- at fixed parameters and one fixed batch, the port's loss and every
  gradient within rtol 1e-5 / atol 1e-6 of jax.grad's, and one Adam step
  within 1e-6 of optax's;
- test_synth.py's bars on the port alone: 800 steps give dev frame
  accuracy > 0.5, and the trained model decodes 3 fresh utterances through
  the port's Recognizer(device="cpu") at WER < 0.15;
- a model the port trained loads in JAX's Recognizer and gives the port's
  transcripts.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import CPU
from catears_tpu.am import nnet as jnn
from catears_tpu.tools import biggraph as jbiggraph
from catears_tpu.tools import synth as jsynth
from catears_tpu.tools import toy as jtoy
from catears_tpu_torch.am import nnet as tnn
from catears_tpu_torch.frontend.fbank import Fbank, num_frames
from catears_tpu_torch.tools import biggraph, synth, toy
from catears_tpu_torch.utils.errors import CatEarsError

NUM_PHONES, VARIANTS = 20, 1


def _graph(pkg):
    return pkg.make_trie_graph(np.random.RandomState(0), num_words=60,
                               num_phones=NUM_PHONES, variants=VARIANTS,
                               bigram_states=15, phones_per_word=(3, 5))


def _setup(bg, sy, ty, rng):
    g = bg.make_trie_graph(rng, num_words=60, num_phones=NUM_PHONES,
                           variants=VARIANTS, bigram_states=15,
                           phones_per_word=(3, 5))
    synthesizer = sy.Synthesizer(g, NUM_PHONES, VARIANTS, rng)
    spec = ty.make_toy_nnet(rng, hidden=64, num_pdfs=g.num_pdfs,
                            num_tdnn_layers=2)
    return g, synthesizer, spec


@pytest.mark.parametrize("markov", [False, True])
def test_synthesizer_equals_jax(markov):
    rngs = np.random.RandomState(0), np.random.RandomState(0)
    tg, jg = _graph(biggraph), _graph(jbiggraph)
    ts = synth.Synthesizer(tg, NUM_PHONES, VARIANTS, rngs[0], markov=markov)
    js = jsynth.Synthesizer(jg, NUM_PHONES, VARIANTS, rngs[1], markov=markov)
    assert np.array_equal(ts.freqs, js.freqs)
    for _ in range(4):
        (w, t, words), (jw, jt, jwords) = (s.utterance(r, 300)
                                           for s, r in zip((ts, js), rngs))
        assert w.dtype == jw.dtype and w.tobytes() == jw.tobytes()
        assert t.dtype == jt.dtype and np.array_equal(t, jt)
        assert words == jwords
        nf = num_frames(w.shape[0])
        assert np.array_equal(synth.fbank_labels(t, nf),
                              jsynth.fbank_labels(jt, nf))
    labels = [np.random.RandomState(i).randint(0, 60, 200) for i in range(3)]
    got = synth.empirical_prior(labels, 60)
    assert got.tobytes() == jsynth.empirical_prior(labels, 60).tobytes()


def test_write_trained_model_byte_identical(tmp_path):
    g = _graph(biggraph)
    spec = toy.make_toy_nnet(np.random.RandomState(1), hidden=32,
                             num_pdfs=g.num_pdfs, num_tdnn_layers=2)
    jspec = jtoy.make_toy_nnet(np.random.RandomState(1), hidden=32,
                               num_pdfs=g.num_pdfs, num_tdnn_layers=2)
    prior = synth.empirical_prior(
        [np.random.RandomState(2).randint(0, g.num_pdfs, 500)], g.num_pdfs)
    ours = synth.write_trained_model(str(tmp_path / "t"), g, spec, prior)
    theirs = jsynth.write_trained_model(str(tmp_path / "j"), _graph(jbiggraph),
                                        jspec, prior)
    assert [os.path.basename(p) for p in ours] == [
        os.path.basename(p) for p in theirs]
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 8
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "j", tmp_path / "t",
                                               names, shallow=False)
    assert not mismatch and not errors and len(match) == 8


def _fixed_batch():
    """A toy TDNN with train_am's leading BatchNorm, one batch of 4
    windows (128 output rows each) and labels."""
    from catears_tpu_torch.io import binfmt

    rng = np.random.RandomState(3)
    spec = toy.make_toy_nnet(rng, hidden=32, num_pdfs=24, num_tdnn_layers=2)
    spec.layers.insert(0, binfmt.LayerSpec(
        binfmt.LAYER_BATCHNORM, scale=rng.rand(40).astype(np.float32) + 0.5,
        offset=rng.randn(40).astype(np.float32)))
    span = 128 + spec.left_context + spec.right_context
    x = (rng.randn(4, span, 40) * 2 + 1).astype(np.float32)
    y = rng.randint(0, 24, (4, 128)).astype(np.int32)
    nnet_def, params = tnn.build_nnet(spec)
    return nnet_def, params, x, y


def _jax_loss(nnet_def, p, x, y):
    """The JAX tool's loss (train_am's closure)."""
    out = jax.vmap(lambda xx: jnn.nnet_forward(nnet_def, p, xx))(x)
    ll = jnp.take_along_axis(out, y[:, :, None], axis=2)[:, :, 0]
    return -jnp.mean(ll)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's loss and gradients at _fixed_batch(), and its parameters after
    one optax Adam step (lr 2e-3)."""
    nnet_def, params, x, y = _fixed_batch()
    jparams = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    jloss, jgrads = jax.value_and_grad(_jax_loss, argnums=1)(
        nnet_def, jparams, jnp.asarray(x), jnp.asarray(y))
    adam = optax.adam(2e-3)
    updates, _ = adam.update(jgrads, adam.init(jparams))
    return jloss, jgrads, optax.apply_updates(jparams, updates)


def test_loss_and_gradients_equal_jax_grad(jax_step):
    nnet_def, params, x, y = _fixed_batch()
    tparams = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
               for p in params]
    loss = synth.loss_fn(nnet_def, tparams, torch.from_numpy(x),
                         torch.from_numpy(y))
    loss.backward()
    jloss, jgrads, _ = jax_step
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-6)
    n = 0
    for tp, jp in zip(tparams, jgrads):
        for k in tp:
            np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            n += 1
    assert n == 2 * sum(layer[0] in ("linear", "batchnorm")
                        for layer in nnet_def)


def test_one_adam_step_equals_optax(jax_step):
    nnet_def, params, x, y = _fixed_batch()
    tparams = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
               for p in params]
    opt = torch.optim.Adam([v for p in tparams for v in p.values()],
                           lr=2e-3, betas=(0.9, 0.999), eps=1e-8)
    synth.loss_fn(nnet_def, tparams, torch.from_numpy(x),
                  torch.from_numpy(y)).backward()
    opt.step()
    stepped = jax_step[2]
    for tp, jp in zip(tparams, stepped):
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=k)


@pytest.mark.slow  # JAX's train_am compiles its step: ~15 s
def test_train_am_steps_equal_jax():
    """Both tools on the same features draw the same windows, BatchNorm,
    dev split and batches: after 3 steps every parameter is within 1e-5
    (3 Adam steps of lr 2e-3 from equal gradients) and the dev accuracy
    is equal."""
    from catears_tpu.frontend.fbank import fbank_from_wave

    rng = np.random.RandomState(0)
    g, synthesizer, spec = _setup(biggraph, synth, toy, rng)
    data = []
    for _ in range(6):
        s, t, _ = synthesizer.utterance(rng, 300)
        nf = num_frames(s.shape[0])
        f = np.asarray(fbank_from_wave(jnp.asarray(s), nf))
        data.append((f, synth.fbank_labels(t, nf)[
            spec.left_context:nf - spec.right_context]))
    ours, acc = synth.train_am(spec, data, steps=3, device=CPU)
    theirs, jacc = jsynth.train_am(spec, data, steps=3)
    assert acc == pytest.approx(jacc, abs=1e-6)
    assert len(ours.layers) == len(theirs.layers) == len(spec.layers) + 1
    for a, b in zip(ours.layers, theirs.layers):
        for name in ("weight", "bias", "scale", "offset"):
            x, y = getattr(a, name, None), getattr(b, name, None)
            if y is not None:
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-5,
                                           err_msg=name)


def test_train_am_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = toy.make_toy_nnet(np.random.RandomState(0), hidden=8, num_pdfs=4)
    with pytest.raises(CatEarsError, match="no CUDA device"):
        synth.train_am(spec, [], steps=1)


@pytest.fixture(scope="module")
def trained():
    """test_synth.py's fixture on the port alone: features from the port's
    Fbank, 800 steps of train_am on the CPU."""
    rng = np.random.RandomState(0)
    g, synthesizer, spec = _setup(biggraph, synth, toy, rng)
    left, right = spec.left_context, spec.right_context
    fbank = Fbank(device=CPU)
    data, labels_all = [], []
    for _ in range(24):
        s, t, _ = synthesizer.utterance(rng, 300)
        nf = num_frames(s.shape[0])
        f = fbank.compute(s)
        lab = synth.fbank_labels(t, nf)
        labels_all.append(lab)
        data.append((f, lab[left:nf - right]))
    spec2, acc = synth.train_am(spec, data, steps=800, batch=8, device=CPU)
    prior = synth.empirical_prior(labels_all, g.num_pdfs)
    return g, synthesizer, spec2, prior, acc


def test_trains_to_usable_accuracy(trained):
    acc = trained[4]
    # 60 pdfs, distinct formant signatures: far above chance, below
    # perfect (boundary frames + noise stay confusable).
    assert acc > 0.5, acc


@pytest.fixture(scope="module")
def decoded(trained, tmp_path_factory):
    """3 fresh utterances written as WAVs, decoded by the port's
    Recognizer on the CPU: (conf, wavs, truths, hypotheses)."""
    from catears_tpu_torch.decode.beam import BeamConfig
    from catears_tpu_torch.runtime.recognizer import (Recognizer,
                                                      decode_wav_file)

    g, synthesizer, spec2, prior, _ = trained
    d = tmp_path_factory.mktemp("torch_synth")
    our_conf, _ = synth.write_trained_model(str(d), g, spec2, prior)
    cfg = BeamConfig(beam_size=512, expand_size=4096, eps_expand_size=2048,
                     max_eps_iters=3)
    rec = Recognizer(our_conf, beam_config=cfg, device=CPU)
    rng = np.random.RandomState(77)
    wavs, truths, hyps = [], [], []
    for i in range(3):
        s, _, words = synthesizer.utterance(rng, 300)
        wav = str(d / f"t{i}.wav")
        synth.write_wav(wav, s)
        wavs.append(wav)
        truths.append([f"word{w}" for w in words])
        hyps.append(decode_wav_file(rec, wav))
    return our_conf, wavs, truths, hyps


def test_decodes_spoken_words_from_audio(decoded):
    from catears_tpu_torch.tools.score import edit_distance

    _, _, truths, hyps = decoded
    errs = sum(edit_distance(t, h.split())[0] for t, h in zip(truths, hyps))
    wer = errs / max(1, sum(len(t) for t in truths))
    assert wer < 0.15, wer


def test_ports_model_decodes_alike_in_jax(decoded):
    from catears_tpu.decode.beam import BeamConfig
    from catears_tpu.runtime.recognizer import Recognizer, decode_wav_file

    conf, wavs, _, hyps = decoded
    cfg = BeamConfig(beam_size=512, expand_size=4096, eps_expand_size=2048,
                     max_eps_iters=3)
    rec = Recognizer(conf, beam_config=cfg)
    assert [decode_wav_file(rec, w) for w in wavs] == hyps
    assert all(h.split() for h in hyps)
