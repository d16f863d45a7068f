"""Multi-process tests for catears_tpu_torch.parallel.distributed (the
counterparts of tests/test_distributed.py).

Spawns two real OS processes that join one gloo process group over
localhost on the CPU (by address, and by torchrun's environment):
initialize(), local_batch_slice() and global_sum() across the two, then
each decodes its local slice of a ragged batch through a ShardedPipeline
over 2 logical CPU devices, which must equal the single-process decode of
that slice (beam states and trace words equal, costs within 1e-3,
log-probs within 2e-4: tests/test_parallel.py's bars), and leaves the group
with shutdown() (without it a rank can abort at exit).  Each process has a
timeout.  Plus the single-process no-op case, and
tools.dist_decode under torchrun against the tool alone.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
pid, n = int(sys.argv[1]), int(sys.argv[2])
port, how = sys.argv[3], sys.argv[4]

from catears_tpu_torch.parallel import distributed

if how == "tcp":
    distributed.initialize(f"localhost:{port}", num_processes=n,
                           process_id=pid)
else:  # torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
    distributed.initialize()
import torch.distributed as dist
assert dist.get_world_size() == n and dist.get_rank() == pid

# Deterministic contiguous split of a non-divisible global batch
lo, hi = distributed.local_batch_slice(5)
assert (lo, hi) == ((0, 3) if pid == 0 else (3, 5)), (pid, lo, hi)
lo, hi = distributed.local_batch_slice(4)
assert (lo, hi) == ((0, 2) if pid == 0 else (2, 4)), (pid, lo, hi)

# Cross-process metric reduction
total = distributed.global_sum(float(pid) + 1.5)
assert abs(total - 4.0) < 1e-9, total

# Deterministic pipeline, identical in every process.
from catears_tpu_torch.am.model import AcousticModel
from catears_tpu_torch.am.nnet import build_nnet
from catears_tpu_torch.decode.beam import (BeamConfig, decode_chunk,
                                           init_beam_batch)
from catears_tpu_torch.frontend.fbank import fbank_from_wave, num_frames
from catears_tpu_torch.graph.device import DeviceFst
from catears_tpu_torch.graph.fst import FlatFst
from catears_tpu_torch.graph.transform import prepare_decode_graph
from catears_tpu_torch.parallel.mesh import ShardedPipeline, make_mesh
from catears_tpu_torch.tools.toy import make_phone_loop_graph, make_toy_nnet

cpu = torch.device("cpu")
rng = np.random.RandomState(0)
graph = make_phone_loop_graph(rng, num_words=10, num_pdfs=64)
nnet = make_toy_nnet(rng, hidden=64, num_pdfs=64, num_tdnn_layers=3)
nnet_def, params = build_nnet(nnet)
prior = np.full(64, 1.0 / 64, np.float32)
am = AcousticModel(nnet_def, params, np.log(prior), graph.tid2pdf,
                   nnet.left_context, nnet.right_context, chunk_size=8,
                   num_pdfs=64, device=cpu)
fst = FlatFst.from_raw(graph.fst)
dec_fst, olab2, mode = prepare_decode_graph(fst)
dfst = DeviceFst.build(dec_fst, graph.tid2pdf,
                       eps_depth_cap=1 if mode != "raw" else None,
                       olabel2=olab2, device=cpu)
cfg = BeamConfig(beam_size=64, expand_size=512, eps_expand_size=256,
                 max_eps_iters=3)

batch, samples = 8, 4000
n_frames = num_frames(samples)
rng2 = np.random.RandomState(7)
wave = (rng2.randn(batch, samples) * 1000).astype(np.float32)
lengths = rng2.randint(n_frames // 2, n_frames + 1,
                       size=batch).astype(np.int32)
lo, hi = distributed.local_batch_slice(batch)

# Single-process reference decode of this process's slice.
with torch.no_grad():
    ref_logp = np.stack([am.forward(fbank_from_wave(
        torch.from_numpy(wave[i]), n_frames).numpy()) for i in range(lo, hi)])
    beam_ref, _ = init_beam_batch(cfg, hi - lo, dfst)
    valid = torch.from_numpy(np.arange(n_frames)[:, None]
                             < lengths[None, lo:hi])
    beam_ref, traces_ref = decode_chunk(
        cfg, dfst, beam_ref,
        torch.from_numpy(np.ascontiguousarray(
            np.transpose(ref_logp, (1, 0, 2)))), valid)

# This process's slice over its own mesh of 2 logical devices.
mesh = make_mesh(2, devices=[cpu, cpu])
pipe = ShardedPipeline(am, dfst, None, cfg, mesh)
logp, beam, traces = pipe.jit_full_step(n_frames)(
    torch.from_numpy(wave[lo:hi]), pipe.make_beam(hi - lo),
    torch.from_numpy(lengths[lo:hi]))
np.testing.assert_allclose(logp.numpy(), ref_logp, atol=2e-4)
assert torch.equal(beam.states, beam_ref.states)
np.testing.assert_allclose(beam.costs.numpy(), beam_ref.costs.numpy(),
                           atol=1e-3)
assert torch.equal(traces.words, traces_ref.words)
frames = distributed.global_sum(float(lengths[lo:hi].sum()))
assert frames == float(lengths.sum()), (frames, lengths.sum())
print(f"worker {pid} ok ({hi - lo} utterances, {frames:.0f} frames)")
distributed.shutdown()
assert not dist.is_initialized()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("how", ["tcp", "env"])
def test_two_process_init_slice_sum_and_decode(tmp_path, how):
    """`how`: initialize(address, n, id) (tcp://), or initialize() reading
    the variables torchrun sets (env://)."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    if how == "env":
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, str(script), str(i), "2",
                               str(port), how],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              env=dict(env, RANK=str(i)), text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"worker {i} ok" in out


def test_single_process_noop():
    """num_processes <= 1 must not start a process group (and shutdown()
    has none to leave)."""
    import torch.distributed as dist

    from catears_tpu_torch.parallel import distributed

    distributed.initialize(num_processes=1)  # must be a no-op
    assert not dist.is_initialized()
    lo, hi = distributed.local_batch_slice(7)
    assert (lo, hi) == (0, 7)
    assert distributed.global_sum(2.5) == 2.5
    distributed.shutdown()
    assert not dist.is_initialized()


def test_dist_decode_tool_two_ranks_equal_one(tmp_path, data_dir, capsys):
    """tools.dist_decode under torchrun (2 ranks, env://, on the CPU)
    prints the same transcripts, in slice order, as the tool alone, and
    rank 0 the utterance count summed over the ranks."""
    import numpy as np

    from catears_tpu_torch.tools.toy import write_toy_model

    conf = write_toy_model(str(tmp_path), rng=np.random.RandomState(5),
                           num_words=20, hidden=64, num_pdfs=96)
    scp = tmp_path / "list.scp"
    scp.write_text("".join(
        f"u{i} {os.path.join(data_dir, f'en-us-{w}.wav')}\n"
        for i, w in enumerate(("hello", "cat", "cat", "hello", "hello"))))
    from catears_tpu_torch.tools import dist_decode

    args = ["--device=cpu", conf, str(scp)]
    assert "WORLD_SIZE" not in os.environ
    assert dist_decode.main(args) == 0  # alone: one rank, in this process
    alone = capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=REPO)
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node=2",
         f"--master-port={_free_port()}", "-m",
         "catears_tpu_torch.tools.dist_decode", *args], capture_output=True,
        text=True, cwd=REPO, env=env, timeout=240)
    assert ranks.returncode == 0, ranks.stderr
    lines = alone.out.splitlines()
    assert len(lines) == 5 and all(len(x.split()) > 1 for x in lines)
    assert sorted(ranks.stdout.splitlines()) == sorted(lines)
    assert "ranks=2 utterances=5" in ranks.stderr
    assert "ranks=1 utterances=5" in alone.err
