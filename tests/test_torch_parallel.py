"""The port's mesh parallelism (`catears_tpu_torch.parallel.mesh`) vs its
unsharded decode and vs the JAX package's `ShardedPipeline`.

On the CPU: the port's meshes are logical CPU devices ([cpu] * n), JAX's
the 8-device virtual CPU mesh of tests/conftest.py.  At the sizes of
tests/test_parallel.py (phone loop of 6 words, TDNN-64, 32 pdfs, beam 64,
8 x 0.25 s), with these tolerances:
- sharded vs the port's unsharded path: log-probs within 2e-4 (the column
  blocks' products round differently), beam states and trace words equal,
  costs within 1e-3 — the JAX test's bars;
- vs JAX's ShardedPipeline: log-probs within 1e-4 (the float AM's
  tolerance, test_torch_exports.py); beam states, LM states, costs and
  trace words equal when both pipelines decode the same (JAX's) log-probs;
- `shard_am_params`' blocks equal JAX's addressable shards exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_same, to_np
from catears_tpu.am.model import AcousticModel as JaxAcousticModel
from catears_tpu.am.nnet import build_nnet as jbuild_nnet
from catears_tpu.decode import beam as jbeam
from catears_tpu.graph.device import DeviceFst as JaxDeviceFst
from catears_tpu.graph.device import DeviceLm as JaxDeviceLm
from catears_tpu.graph.fst import FlatFst as JaxFlatFst
from catears_tpu.parallel import mesh as jmesh
from catears_tpu.tools import biggraph as jbiggraph
from catears_tpu.tools import toy as jtoy
from catears_tpu_torch.am.model import AcousticModel
from catears_tpu_torch.am.nnet import build_nnet
from catears_tpu_torch.decode.beam import (BeamConfig, decode_chunk,
                                           init_beam_batch)
from catears_tpu_torch.frontend.fbank import fbank_from_wave, num_frames
from catears_tpu_torch.graph.device import DeviceFst, DeviceLm
from catears_tpu_torch.graph.fst import FlatFst
from catears_tpu_torch.parallel import mesh as tmesh
from catears_tpu_torch.tools import biggraph, toy
from catears_tpu_torch.utils.errors import CatEarsError

NUM_PDFS = 32
SAMPLES = 4000  # 0.25 s
T = num_frames(SAMPLES)
KW = dict(beam_size=64, expand_size=512, eps_expand_size=256,
          max_eps_iters=3)


def _models(mod_toy, mod_nnet, mod_am, mod_fst, seed=0, **am_kw):
    rng = np.random.RandomState(seed)
    graph = mod_toy.make_phone_loop_graph(rng, num_words=6,
                                          num_pdfs=NUM_PDFS)
    nnet = mod_toy.make_toy_nnet(rng, hidden=64, num_pdfs=NUM_PDFS)
    nnet_def, params = mod_nnet(nnet)
    prior = np.full(NUM_PDFS, 1.0 / NUM_PDFS, np.float32)
    am = mod_am(nnet_def, params, np.log(prior), graph.tid2pdf,
                nnet.left_context, nnet.right_context, 8, NUM_PDFS, **am_kw)
    return am, mod_fst.from_raw(graph.fst), graph.tid2pdf


@pytest.fixture(scope="module")
def setup():
    """(port: am, dfst, cfg), (JAX: am, dfst, cfg), both from seed 0."""
    am, fst, tid2pdf = _models(toy, build_nnet, AcousticModel, FlatFst,
                               device=CPU)
    jam, jfst, jtid2pdf = _models(jtoy, jbuild_nnet, JaxAcousticModel,
                                  JaxFlatFst)
    return ((am, DeviceFst.build(fst, tid2pdf, device=CPU), BeamConfig(**KW)),
            (jam, JaxDeviceFst.build(jfst, jtid2pdf), jbeam.BeamConfig(**KW)))


def _wave(seed, batch=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, SAMPLES) * 1000).astype(np.float32)


def _unsharded(am, dfst, cfg, wave, lengths=None, dlm=None):
    """The port's single-device path: am.forward per utterance, one
    decode_chunk over the whole batch."""
    with torch.no_grad():
        logp = np.stack([am.forward(fbank_from_wave(
            torch.from_numpy(w), T).numpy()) for w in wave])
        beam, _ = init_beam_batch(cfg, len(wave), dfst, dlm)
        lens = np.full(len(wave), T) if lengths is None else lengths
        valid = torch.from_numpy(np.arange(T)[:, None] < lens[None, :])
        beam, traces = decode_chunk(cfg, dfst, beam, torch.from_numpy(
            np.ascontiguousarray(np.transpose(logp, (1, 0, 2)))), valid, dlm)
    return logp, beam, traces


def _sharded(am, dfst, cfg, wave, n, mp, lengths=None, dlm=None):
    mesh = tmesh.make_mesh(n, model_parallel=mp, devices=[CPU] * n)
    pipe = tmesh.ShardedPipeline(am, dfst, dlm, cfg, mesh)
    step = pipe.jit_full_step(T)
    return pipe, step(torch.from_numpy(wave), pipe.make_beam(len(wave)),
                      None if lengths is None else torch.from_numpy(lengths))


def _hold_to_unsharded(sharded, ref):
    (logp, beam, traces), (ref_logp, ref_beam, ref_traces) = sharded, ref
    np.testing.assert_allclose(to_np(logp), ref_logp, rtol=0, atol=2e-4)
    assert_same(ref_beam.states, beam.states, "states")
    assert_same(ref_beam.lm, beam.lm, "lm states")
    np.testing.assert_allclose(to_np(beam.costs), to_np(ref_beam.costs),
                               rtol=0, atol=1e-3)
    assert_same(ref_traces.words, traces.words, "trace words")
    assert_same(ref_traces.prev_slot, traces.prev_slot, "trace prev_slot")


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_sharded_equals_unsharded(setup, model_parallel):
    am, dfst, cfg = setup[0]
    wave = _wave(1)
    _, out = _sharded(am, dfst, cfg, wave, 8, model_parallel)
    assert out[0].shape == (8, T, NUM_PDFS)
    _hold_to_unsharded(out, _unsharded(am, dfst, cfg, wave))


def test_sharded_ragged_lengths(setup):
    """Utterance b decodes exactly lengths[b] frames, as the unsharded
    ragged decode does (tests/test_parallel.py's case)."""
    am, dfst, cfg = setup[0]
    wave = _wave(3, batch=4)
    lengths = np.array([T, T // 2, T - 1, 3], np.int32)
    _, out = _sharded(am, dfst, cfg, wave, 4, 1, lengths)
    _hold_to_unsharded(out, _unsharded(am, dfst, cfg, wave, lengths))


def _jax_step(jsetup, wave, mp, lengths=None, jdlm=None):
    jam, jdfst, jcfg = jsetup
    mesh = jmesh.make_mesh(8, model_parallel=mp)
    pipe = jmesh.ShardedPipeline(jam, jdfst, jdlm, jcfg, mesh)
    w = jax.device_put(jnp.asarray(wave), pipe.data_sharding)
    args = [w, pipe.make_beam(len(wave))]
    if lengths is not None:
        args.append(jax.device_put(jnp.asarray(lengths), pipe.data_sharding))
    with mesh:
        logp, beam, traces = pipe.jit_full_step(T)(*args)
        return (np.asarray(logp), [np.asarray(x) for x in beam],
                [np.asarray(x) for x in traces])


def _fed(pipe, logp):
    """Make `pipe` decode the given [B, T, P] log-probs instead of its
    AM's (block d of the batch for data row d)."""
    per = logp.shape[0] // len(pipe.homes)
    pipe._am_block = lambda d, wave, n: torch.tensor(
        logp[d * per:(d + 1) * per]).to(pipe.homes[d])


def _hold_to_jax(pipe, ours, jax_out, wave, lengths=None):
    jlogp, jbeam_out, jtraces = jax_out
    np.testing.assert_allclose(to_np(ours[0]), jlogp, rtol=0, atol=1e-4)
    _fed(pipe, jlogp)
    logp, beam, traces = pipe.full_step(
        torch.from_numpy(wave), pipe.make_beam(len(wave)),
        None if lengths is None else torch.from_numpy(lengths), n_frames=T)
    for name in ("states", "lm", "costs", "overflow", "hiwater"):
        assert_same(jbeam_out[beam._fields.index(name)],
                    getattr(beam, name), name)
    assert_same(jtraces[1], traces.words, "trace words")
    assert_same(jtraces[0], traces.prev_slot, "trace prev_slot")


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_equals_jax_sharded_pipeline(setup, model_parallel):
    am, dfst, cfg = setup[0]
    wave = _wave(1)
    lengths = np.random.RandomState(5).randint(T // 2, T + 1,
                                               size=8).astype(np.int32)
    pipe, ours = _sharded(am, dfst, cfg, wave, 8, model_parallel, lengths)
    _hold_to_jax(pipe, ours, _jax_step(setup[1], wave, model_parallel,
                                       lengths), wave, lengths)


def test_with_a_delta_lm(setup):
    """A DeviceLm (a G' over the loop's 6 words) rides every data block:
    sharded == unsharded, and == JAX's pipeline on the same log-probs."""
    am, dfst, _ = setup[0]
    jam, jdfst, _ = setup[1]
    kw = dict(KW, lm_expand_size=64)
    cfg, jcfg = BeamConfig(**kw), jbeam.BeamConfig(**kw)
    dlm = DeviceLm.build(biggraph.make_big_lm(np.random.RandomState(3),
                                              num_words=6).delta_lm(),
                         device=CPU)
    jdlm = JaxDeviceLm.build(jbiggraph.make_big_lm(
        np.random.RandomState(3), num_words=6).delta_lm())
    wave = _wave(4)
    pipe, ours = _sharded(am, dfst, cfg, wave, 8, 2, dlm=dlm)
    assert to_np(ours[1].lm).any()  # the LM states moved
    _hold_to_unsharded(ours, _unsharded(am, dfst, cfg, wave, dlm=dlm))
    _hold_to_jax(pipe, ours, _jax_step((jam, jdfst, jcfg), wave, 2,
                                       jdlm=jdlm), wave)


def test_shard_am_params_equal_jax_shards(setup):
    am = setup[0][0]
    jam = setup[1][0]
    mesh = tmesh.make_mesh(8, model_parallel=2, devices=[CPU] * 8)
    jm = jmesh.make_mesh(8, model_parallel=2)
    ours = tmesh.shard_am_params(am, mesh)
    theirs = jmesh.shard_am_params(jam, jm)
    where = {dev: tuple(int(i) for i in np.argwhere(jm.devices == dev)[0])
             for dev in jm.devices.flat}
    checked = 0
    for i, (mine, ref) in enumerate(zip(ours, theirs)):
        kind = am.nnet_def[i][0]
        assert set(mine) == ({"w", "b"} if kind == "linear" else
                             {"scale", "offset"} if kind == "batchnorm"
                             else set()), kind
        for name, blocks in mine.items():
            assert len(blocks) == 4 and all(len(r) == 2 for r in blocks)
            for shard in ref[name].addressable_shards:
                d, j = where[shard.device]
                assert_same(np.asarray(shard.data), blocks[d][j],
                            f"layer {i} {name} block ({d}, {j})")
                checked += 1
    assert checked == 8 * 2 * sum(layer[0] in ("linear", "batchnorm")
                                  for layer in am.nnet_def)


def test_one_copy_per_distinct_device(setup):
    """Shards that share a device share one copy of every weight block and
    table."""
    am, dfst, cfg = setup[0]
    mesh = tmesh.make_mesh(8, model_parallel=2, devices=[CPU] * 8)
    pipe = tmesh.ShardedPipeline(am, dfst, None, cfg, mesh)
    assert len(pipe._tables) == 1
    w = pipe.params[[k[0] for k in am.nnet_def].index("linear")]["w"]
    assert all(w[d][j] is w[0][j] for d in range(4) for j in range(2))
    assert w[0][0] is not w[0][1]


def test_uneven_batch_and_mesh_errors(setup, monkeypatch):
    am, dfst, cfg = setup[0]
    mesh = tmesh.make_mesh(4, devices=[CPU] * 4)
    assert mesh.shape == {"data": 4, "model": 1} and mesh.devices.size == 4
    pipe = tmesh.ShardedPipeline(am, dfst, None, cfg, mesh)
    with pytest.raises(CatEarsError, match="does not split"):
        pipe.am_step(torch.from_numpy(_wave(0, batch=6)), T)
    with pytest.raises(AssertionError):
        tmesh.make_mesh(6, model_parallel=4, devices=[CPU] * 6)
    with pytest.raises(CatEarsError, match="only 2 given"):
        tmesh.make_mesh(4, devices=[CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CatEarsError, match="no CUDA device"):
        tmesh.make_mesh(2)
    with pytest.raises(CatEarsError, match="no CUDA device"):
        tmesh.make_mesh(2, devices=["cuda:0"] * 2)


def test_am_step_equals_full_step_logp(setup):
    am, dfst, cfg = setup[0]
    wave = _wave(6)
    pipe, out = _sharded(am, dfst, cfg, wave, 8, 2)
    assert_same(out[0], pipe.am_step(wave, T), "am_step")


def test_dryrun_multichip_on_the_cpu(capsys):
    from catears_tpu_torch.graft_entry import dryrun_multichip, entry

    dryrun_multichip(8, device="cpu")
    assert "mesh=(data=4, model=2)" in capsys.readouterr().out
    fn, (wave,) = entry(device="cpu")
    logp, costs = fn(wave)
    assert logp.shape[0] == costs.shape[0] == 2
    assert torch.isfinite(costs).any()
