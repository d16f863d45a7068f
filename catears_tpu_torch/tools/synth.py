"""Synthetic phone audio + trained acoustic models for accuracy realism
(port of catears_tpu/tools/synth.py).

The bench's planted pseudo-likelihoods (tools.biggraph.plant_logp) are a
load generator: they exercise the decoder's search at production intensity
but say nothing about behavior under genuinely confusable acoustics.  This
module closes that gap as far as a hermetic environment allows, following
the reference's own validation methodology (decode real audio through the
full wave -> fbank -> AM -> search pipeline and score it,
the reference's doc/debug.md):

  * `synth_utterance` renders a REAL waveform for a random walk through a
    TrieGraph: each pdf (phone, hmm-state, variant) gets a formant-like
    spectral signature (3 sinusoid banks + noise), phones blend at window
    boundaries, variants of the same phone are nearly identical — so mel
    features genuinely confuse adjacent phones, states and variants.
  * `train_am` trains the standard TDNN layer stack (am.nnet, the same
    NN02 grammar the runtime loads) on (fbank, pdf-label) pairs with its
    own front-end, on the card (torch autograd + Adam with optax's
    formula; the JAX tool trains with optax).
  * `write_trained_model` exports the trained AM + graph in BOTH this
    framework's and the reference binary's artifact formats, so the same
    WAV files can be decoded by both engines and scored side by side
    (scripts/realism.py).

Everything is deterministic in the given rng.
"""

from __future__ import annotations

import copy
from typing import List, Tuple

import numpy as np
import torch

from catears_tpu_torch.am.nnet import build_nnet, nnet_forward
from catears_tpu_torch.io import binfmt
from catears_tpu_torch.io.binfmt import LayerSpec
from catears_tpu_torch.tools.biggraph import TrieGraph
from catears_tpu_torch.utils.device import Device, resolve_device

SAMPLE_RATE = 16000
HOP = 160  # 10 ms


def _pdf_signature(num_pdfs: int, num_phones: int, variants: int,
                   rng: np.random.RandomState):
    """Per-pdf sinusoid banks: freqs [P, 3], amps [P, 3].

    Phones get formant-like (f1, f2, f3) spread over the usable band with
    spacing comparable to mel-bin resolution (overlapping -> confusable);
    HMM states scale the formants slightly (onset/steady/offset drift);
    variants add a sub-resolution offset so context variants of a phone
    are nearly indistinguishable — the graph, not the AM, must pick them.
    """
    pdfs = np.arange(num_pdfs)
    v = pdfs % variants
    state = (pdfs // variants) % 3
    phone = pdfs // (variants * 3)
    # Deterministic per-phone formants (rng used once for the layout).
    f1 = 150.0 + 3400.0 * rng.rand(num_phones)
    f2 = 800.0 + 5000.0 * rng.rand(num_phones)
    f3 = 2500.0 + 4800.0 * rng.rand(num_phones)
    base = np.stack([f1[phone], f2[phone], f3[phone]], axis=1)  # [P, 3]
    drift = np.array([0.95, 1.0, 1.06])[state][:, None]
    var_off = ((v[:, None] - variants / 2.0) * 7.0)  # sub-mel-bin Hz
    freqs = np.clip(base * drift + var_off, 80.0, 7600.0)
    amps = np.stack([np.full(num_pdfs, 1.0),
                     np.full(num_pdfs, 0.6),
                     np.full(num_pdfs, 0.35)], axis=1)
    return freqs.astype(np.float64), amps.astype(np.float64)


class Synthesizer:
    """Waveform renderer for pdf-target sequences of one TrieGraph.

    markov=True gives word sequences BIGRAM structure (each word has a
    hidden set of likely successors) instead of IID pareto draws — the
    structure a corpus-fitted n-gram G' can actually model, so delta-LM
    rescoring has signal to add (scripts/realism.py LM-on experiment).
    The successor table is drawn once from the constructor rng; sampling
    stays deterministic in the per-utterance rng.
    """

    def __init__(self, graph: TrieGraph, num_phones: int, variants: int,
                 rng: np.random.RandomState, snr_noise: float = 0.12,
                 markov: bool = False, markov_p: float = 0.75):
        self.graph = graph
        self.freqs, self.amps = _pdf_signature(graph.num_pdfs, num_phones,
                                               variants, rng)
        self.snr_noise = snr_noise
        self.markov_p = markov_p
        self.successors = None
        if markov:
            # 3 likely successors per word, themselves pareto-biased so
            # the chain keeps revisiting a learnable core vocabulary.
            n = graph.num_words
            self.successors = 1 + np.minimum(
                (rng.pareto(0.8, size=(n + 1, 3)) * 3).astype(np.int64),
                n - 1)

    def _next_word(self, rng: np.random.RandomState, prev: int) -> int:
        g = self.graph
        if self.successors is not None and prev > 0 \
                and rng.rand() < self.markov_p:
            return int(self.successors[prev, rng.randint(3)])
        return 1 + min(int(rng.pareto(0.8) * 3), g.num_words - 1)

    def render(self, rng: np.random.RandomState,
               targets: np.ndarray) -> np.ndarray:
        """[F] pdf targets -> float32 [F * 160] samples (amplitude ~3000).

        Sinusoid phases accumulate across frames (no boundary clicks);
        amplitude jitters per frame; additive white noise at `snr_noise`
        of signal amplitude makes every mel bin stochastic.
        """
        f = targets.shape[0]
        fr = self.freqs[targets]  # [F, 3]
        am = self.amps[targets] * (0.8 + 0.4 * rng.rand(f, 1))
        per_sample_f = np.repeat(fr, HOP, axis=0)  # [F*160, 3]
        per_sample_a = np.repeat(am, HOP, axis=0)
        phase = np.cumsum(2.0 * np.pi * per_sample_f / SAMPLE_RATE, axis=0)
        phase += rng.rand(1, 3) * 2.0 * np.pi
        sig = (per_sample_a * np.sin(phase)).sum(axis=1)
        sig += (self.snr_noise * rng.randn(f * HOP)
                * per_sample_a.sum(axis=1))
        return (sig * 1500.0).astype(np.float32)

    def utterance(self, rng: np.random.RandomState, frames: int
                  ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """(samples [T*160], frame targets [T], true words), T <= frames.

        Unlike plant_targets, the utterance ends ON a word boundary: a
        truncated final word would leave audio for a word that is not in
        the truth AND leave the decode parked mid-trie with no reachable
        final state — a synthesis artifact, not an acoustic error.
        """
        g = self.graph
        targets = np.zeros(frames, np.int32)
        words: List[int] = []
        t = 0
        while True:
            w = self._next_word(rng, words[-1] if words else 0)
            pdfs = g.word_pdf_flat[g.word_pdf_off[w]:g.word_pdf_off[w + 1]]
            durs = rng.randint(2, 5, size=pdfs.size)
            seq = np.repeat(pdfs, durs)
            if t + seq.size > frames:
                if words:
                    break
                continue  # first word longer than the budget: resample
            targets[t:t + seq.size] = seq
            t += seq.size
            words.append(w)
        return self.render(rng, targets[:t]), targets[:t], words


def fbank_labels(targets: np.ndarray, n_frames: int) -> np.ndarray:
    """Align synthesis-frame targets to fbank frame labels.

    fbank frame i windows samples [i*160, i*160+400): its center lands in
    synthesis frame i+1.
    """
    idx = np.minimum(np.arange(n_frames) + 1, targets.shape[0] - 1)
    return targets[idx].astype(np.int32)


def train_am(spec, data: List[Tuple[np.ndarray, np.ndarray]],
             steps: int = 3000, batch: int = 8, lr: float = 2e-3,
             seed: int = 0, log_every: int = 0, device: Device = "cuda"):
    """Train the NN02 TDNN stack on (features [T, 40], labels [T']) pairs.

    labels align with the nnet OUTPUT rows (T' = T - left - right).
    Returns (trained NnetSpec, final held-out frame accuracy).  Training
    runs on `device` (the card unless the CPU is asked for; CatEarsError
    without one): the float stack's parameters with autograd, Adam with
    optax's defaults (b1 0.9, b2 0.999, eps 1e-8: m_hat / (sqrt(v_hat) +
    eps)).  The windows, the leading BatchNorm, the dev split and the
    batch index stream are the JAX tool's, so both draw the same batches.
    """
    device = resolve_device(device)
    spec, feats, labs, n_dev = training_windows(spec, data)
    nnet_def, params = build_nnet(spec)
    params = [{k: torch.tensor(v, device=device, requires_grad=True)
               for k, v in p.items()} for p in params]
    dev_f = torch.from_numpy(feats[:n_dev][:64]).to(device)
    dev_l = torch.from_numpy(labs[:n_dev][:64]).to(device)
    trn_f = torch.from_numpy(feats[n_dev:]).to(device)
    trn_l = torch.from_numpy(labs[n_dev:]).to(device)

    opt = torch.optim.Adam([v for p in params for v in p.values()], lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)

    def accuracy():
        with torch.no_grad():
            out = nnet_forward(nnet_def, params, dev_f)
            return float(torch.mean(
                (torch.argmax(out, dim=2) == dev_l).to(torch.float32)))

    rng = np.random.RandomState(seed)
    for i in range(steps):
        idx = torch.from_numpy(rng.randint(0, trn_f.shape[0], size=batch))
        idx = idx.to(device)
        opt.zero_grad(set_to_none=True)
        loss_fn(nnet_def, params, trn_f[idx], trn_l[idx]).backward()
        opt.step()
        if log_every and (i + 1) % log_every == 0:
            print(f"#   step {i + 1}/{steps} dev-acc {accuracy():.3f}",
                  flush=True)
    acc = accuracy()
    return _specialize(spec, [{k: v.detach().cpu().numpy()
                               for k, v in p.items()} for p in params]), acc


def training_windows(spec, data: List[Tuple[np.ndarray, np.ndarray]]):
    """train_am's training set: (the spec with its leading input
    BatchNorm, windows [N, span, 40], labels [N, 128], the number of
    leading windows held out for the dev accuracy)."""
    left, right = spec.left_context, spec.right_context
    win = 128  # output frames per training window
    span = win + left + right

    feats = np.stack([f[s:s + span]
                      for f, _ in data for s in
                      range(0, f.shape[0] - span, win)])
    labs = np.stack([l[s + 0:s + win]
                     for f, l in data for s in
                     range(0, f.shape[0] - span, win)])
    # Input normalization as a leading (trainable, NN02-exportable)
    # BatchNorm layer: raw log-mel sits around ~28 +- 3, which blows up
    # the randomly-initialized stack.  Baked into the model so the
    # reference binary applies the identical function.
    mu = feats.mean(axis=(0, 1))
    sd = feats.std(axis=(0, 1)) + 1e-3
    spec = copy.deepcopy(spec)
    spec.layers.insert(0, LayerSpec(
        binfmt.LAYER_BATCHNORM, scale=(1.0 / sd).astype(np.float32),
        offset=(-mu / sd).astype(np.float32)))
    # Label row i of a window corresponds to output row i (the narrow
    # layers drop the left/right context rows).
    return spec, feats, labs, max(1, feats.shape[0] // 20)


def loss_fn(nnet_def, params, x, y):
    """Mean negative log-likelihood of labels y [B, T'] under the stack's
    output for windows x [B, T, 40] (the JAX tool's loss)."""
    out = nnet_forward(nnet_def, params, x)
    ll = torch.gather(out, 2, y[:, :, None].long())[:, :, 0]
    return -torch.mean(ll)


def _specialize(spec, params):
    """Write trained params back into a copy of the NnetSpec."""
    out = copy.deepcopy(spec)
    for layer, p in zip(out.layers, params):
        if "w" in p:
            layer.weight = np.asarray(p["w"], np.float32)
            layer.bias = np.asarray(p["b"], np.float32)
        if "scale" in p:
            layer.scale = np.asarray(p["scale"], np.float32)
            layer.offset = np.asarray(p["offset"], np.float32)
    return out


def empirical_prior(labels: List[np.ndarray], num_pdfs: int,
                    floor: float = 1e-5) -> np.ndarray:
    """Smoothed pdf prior from training labels (Kaldi-style: the AM's
    posteriors divide by this to become pseudo-likelihoods)."""
    counts = np.zeros(num_pdfs, np.float64)
    for l in labels:
        counts += np.bincount(l, minlength=num_pdfs)
    prior = counts / counts.sum()
    return np.maximum(prior, floor).astype(np.float32)


def write_wav(path: str, samples: np.ndarray) -> None:
    """Canonical 16-bit mono 16 kHz RIFF/WAVE."""
    import struct

    pcm = np.clip(samples, -32768, 32767).astype("<i2").tobytes()
    with open(path, "wb") as fd:
        fd.write(b"RIFF")
        fd.write(struct.pack("<i", 36 + len(pcm)))
        fd.write(b"WAVEfmt ")
        fd.write(struct.pack("<ihhiihh", 16, 1, 1, SAMPLE_RATE,
                             2 * SAMPLE_RATE, 2, 16))
        fd.write(b"data")
        fd.write(struct.pack("<i", len(pcm)))
        fd.write(pcm)


def write_trained_model(out_dir: str, graph: TrieGraph, spec,
                        prior: np.ndarray) -> Tuple[str, str]:
    """Model dir in BOTH artifact sets; returns (our_conf, ref_conf).

    our_conf loads the graph from pk::fst_0, ref_conf from the OpenFST
    ConstFst export — the reference binary's HCLG path
    (the reference's src/ce_stt.cc:124).  Everything else (NN02 nnet,
    VEC0 prior/tid2pdf, words.txt) is shared byte-identically.
    """
    import os

    from catears_tpu_torch.io.openfst import ConstFst, write_const_fst

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "am.nnet"), "wb") as fd:
        binfmt.write_nnet(fd, spec)
    with open(os.path.join(out_dir, "am.prior"), "wb") as fd:
        binfmt.write_vec0(fd, prior)
    with open(os.path.join(out_dir, "am.tid2pdf"), "wb") as fd:
        binfmt.write_vec0(fd, graph.tid2pdf)
    with open(os.path.join(out_dir, "graph.fst"), "wb") as fd:
        binfmt.write_pkfst(fd, graph.fst.to_raw())
    counts = np.diff(graph.fst.offsets).astype(np.int32)
    cf = ConstFst(start=graph.fst.start, final=graph.fst.final,
                  arc_pos=graph.fst.offsets[:-1].astype(np.int64),
                  arc_count=counts, arc_ilabel=graph.fst.arc_ilabel,
                  arc_olabel=graph.fst.arc_olabel,
                  arc_weight=graph.fst.arc_weight,
                  arc_next=graph.fst.arc_next)
    with open(os.path.join(out_dir, "graph.hclg"), "wb") as fd:
        write_const_fst(fd, cf)
    with open(os.path.join(out_dir, "words.txt"), "w") as fd:
        fd.write("<eps> 0\n")
        for i in range(1, graph.num_words + 1):
            fd.write(f"word{i} {i}\n")
        fd.write(f"<s> {graph.num_words + 1}\n")
        fd.write(f"</s> {graph.num_words + 2}\n")
    common = (f"nnet = am.nnet\nprior = am.prior\n"
              f"left_context = {spec.left_context}\n"
              f"right_context = {spec.right_context}\n"
              f"chunk_size = 20\nnum_pdfs = {prior.shape[0]}\n"
              f"tid2pdf = am.tid2pdf\nsymbol_table = words.txt\n")
    our_conf = os.path.join(out_dir, "ours.conf")
    with open(our_conf, "w") as fd:
        fd.write("fst = graph.fst\n" + common
                 + "arc_group = 2\ncsr_group = 16\n")
    ref_conf = os.path.join(out_dir, "ref.conf")
    with open(ref_conf, "w") as fd:
        fd.write("fst = graph.hclg\n" + common)
    return our_conf, ref_conf
