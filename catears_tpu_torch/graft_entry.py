"""Entry points: the flagship forward step and the multi-device dry run
(port of the repo's __graft_entry__.py).

    python -m catears_tpu_torch.graft_entry [--device=cpu]

runs `entry()`'s step once, then `dryrun_multichip(8)`.  On the card by
default (CatEarsError without one); a machine with fewer cards than the
mesh runs its shards round-robin over the cards there are (one card: n
logical shards of cuda:0).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from catears_tpu_torch.utils.device import Device, resolve_device


def _build_flagship(num_words=50, hidden=256, num_pdfs=512, seed=0,
                    device: Device = "cuda"):
    """Deterministic flagship pipeline: TDNN AM + phone-loop WFST decoder,
    on `device`."""
    from catears_tpu_torch.am.model import AcousticModel
    from catears_tpu_torch.am.nnet import build_nnet
    from catears_tpu_torch.decode.beam import BeamConfig
    from catears_tpu_torch.graph.device import DeviceFst
    from catears_tpu_torch.graph.fst import FlatFst
    from catears_tpu_torch.graph.transform import prepare_decode_graph
    from catears_tpu_torch.tools.toy import (make_phone_loop_graph,
                                             make_toy_nnet)

    rng = np.random.RandomState(seed)
    graph = make_phone_loop_graph(rng, num_words=num_words,
                                  num_pdfs=num_pdfs)
    nnet = make_toy_nnet(rng, hidden=hidden, num_pdfs=num_pdfs,
                         num_tdnn_layers=3)
    nnet_def, params = build_nnet(nnet)
    prior = np.full(num_pdfs, 1.0 / num_pdfs, np.float32)
    am = AcousticModel(nnet_def, params, np.log(prior), graph.tid2pdf,
                       nnet.left_context, nnet.right_context,
                       chunk_size=8, num_pdfs=num_pdfs, device=device)
    fst = FlatFst.from_raw(graph.fst)
    # Production transform pipeline: offline epsilon removal -> eps-free
    # frame loop (the path the real decoder dispatches to).
    dec_fst, olab2, mode = prepare_decode_graph(fst)
    dfst = DeviceFst.build(dec_fst, graph.tid2pdf,
                           eps_depth_cap=1 if mode != "raw" else None,
                           olabel2=olab2, device=device)
    cfg = BeamConfig(beam_size=512, expand_size=4096, eps_expand_size=2048,
                     max_eps_iters=4)
    return am, fst, dfst, cfg


def entry(device: Device = "cuda"):
    """(fn, example_args): the flagship forward step on `device`.

    fn: wave batch [B, S] -> (log-likelihoods [B, T, P], final beam costs
    [B, K]): fbank, TDNN AM forward and a full beam-search pass over the
    frames, all at static shapes.
    """
    from catears_tpu_torch.decode.beam import decode_chunk, init_beam_batch
    from catears_tpu_torch.frontend.fbank import fbank_from_wave, num_frames

    device = resolve_device(device)
    am, fst, dfst, cfg = _build_flagship(device=device)
    batch, samples = 2, 8000  # 0.5 s per utterance
    n_frames = num_frames(samples)

    def forward_step(wave):
        with torch.no_grad():
            feats = fbank_from_wave(wave, n_frames)
            padded = torch.cat([
                feats[:, :1].expand(batch, am.left_context, -1),
                feats,
                feats[:, -1:].expand(batch, am.right_context, -1)], dim=1)
            logp = am.forward_padded(padded)
            beam, _ = init_beam_batch(cfg, batch, dfst)
            logp_t = logp.transpose(0, 1)
            valid = torch.ones(logp_t.shape[:2], dtype=torch.bool,
                               device=device)
            beam, _traces = decode_chunk(cfg, dfst, beam, logp_t, valid)
        return logp, beam.costs

    rng = np.random.RandomState(1)
    wave = (rng.randn(batch, samples) * 1000).astype(np.float32)
    return forward_step, (torch.from_numpy(wave).to(device),)


def dryrun_multichip(n_devices: int, device: Device = "cuda") -> None:
    """Run one full sharded step on an n-device mesh and hold it to the
    unsharded decode.

    Exercises the parallelism of this framework: utterance data
    parallelism over the 'data' axis and column-parallel (tensor-parallel)
    acoustic-model linears over the 'model' axis.
    """
    from catears_tpu_torch.decode.beam import (BeamConfig, decode_chunk,
                                               init_beam_batch)
    from catears_tpu_torch.frontend.fbank import fbank_from_wave, num_frames
    from catears_tpu_torch.parallel.mesh import (ShardedPipeline,
                                                 logical_devices, make_mesh)

    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    devices = logical_devices(n_devices, device)
    mesh = make_mesh(n_devices, model_parallel=model_parallel,
                     devices=devices)
    dp = n_devices // model_parallel

    am, fst, dfst, _ = _build_flagship(num_words=10, hidden=64, num_pdfs=64,
                                       device=devices[0])
    cfg = BeamConfig(beam_size=64, expand_size=512, eps_expand_size=256,
                     max_eps_iters=3)
    pipe = ShardedPipeline(am, dfst, None, cfg, mesh)

    batch = max(dp * 2, 2)
    samples = 4000  # 0.25 s
    n_frames = num_frames(samples)
    rng = np.random.RandomState(2)
    wave_np = (rng.randn(batch, samples) * 1000).astype(np.float32)
    beam = pipe.make_beam(batch)
    # Ragged batch: per-utterance lengths ride the data axis.
    lengths_np = rng.randint(max(1, n_frames // 2), n_frames + 1,
                             size=batch).astype(np.int32)

    step = pipe.jit_full_step(n_frames)
    logp, beam, _traces = step(torch.from_numpy(wave_np), beam,
                               torch.from_numpy(lengths_np))
    logp_sh = logp.cpu().numpy()
    costs = beam.costs.cpu().numpy()
    states = beam.states.cpu().numpy()
    assert logp_sh.shape == (batch, n_frames, am.num_pdfs)
    assert np.isfinite(costs).any(), "beam died in dryrun"

    # The sharded step must EQUAL the unsharded single-device decode: the
    # same log-probs (fp tolerance for the column blocks' products) and
    # the same beam states and costs.
    dev = devices[0]
    with torch.no_grad():
        ref_logp = np.stack([
            am.forward(fbank_from_wave(torch.from_numpy(wave_np[i]).to(dev),
                                       n_frames).cpu().numpy())
            for i in range(batch)])
        np.testing.assert_allclose(logp_sh, ref_logp, atol=2e-4)
        beam_ref, _ = init_beam_batch(cfg, batch, dfst)
        logp_t = torch.from_numpy(np.transpose(ref_logp, (1, 0, 2))).to(dev)
        valid = torch.from_numpy(
            np.arange(n_frames)[:, None] < lengths_np[None, :]).to(dev)
        beam_ref, _ = decode_chunk(cfg, dfst, beam_ref, logp_t, valid)
    np.testing.assert_array_equal(states, beam_ref.states.cpu().numpy())
    np.testing.assert_allclose(costs, beam_ref.costs.cpu().numpy(),
                               atol=1e-3)
    print(f"dryrun_multichip OK: mesh=(data={dp}, model={model_parallel}), "
          f"devices={[str(d) for d in devices]}, batch={batch}, "
          f"frames={n_frames}, ragged lengths {lengths_np.min()}.."
          f"{lengths_np.max()}, sharded == unsharded decode")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--device=cpu" in argv else "cuda"
    fn, args = entry(device)
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(8, device)
    return 0


if __name__ == "__main__":
    from catears_tpu_torch.utils.errors import CatEarsError

    try:
        sys.exit(main())
    except CatEarsError as e:
        print(f"catears: {e}", file=sys.stderr)
        sys.exit(1)
