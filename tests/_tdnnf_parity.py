"""Shared pieces of the TDNN-F tests (tests/test_torch_tdnnf.py on the CPU,
tests/test_torch_cuda.py on a card): a seeded random chain model in
`tdnnf_reference`'s layout and its NN02 layers, a small chain-topology
graph with planted paths, and a chain model directory the Recognizer
reads.  Imports no JAX."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

import tdnnf_reference as ref
from catears_tpu_torch.io import binfmt
from catears_tpu_torch.graph.fst import FlatFst

FEAT = 40


def make_model(rng: np.random.RandomState, dim: int = 64, neck: int = 16,
               strides: Sequence[int] = (1, 0, 3, 3), pdfs: int = 48,
               ivector_dim: int = 10, small: int = 16,
               subsample: int = 3) -> Dict:
    """A chain TDNN-F with seeded weights (randn / sqrt(fan in), biases
    0.1 randn, batchnorm scale 1 + 0.1 U and offset 0.05 randn)."""
    def w(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)

    def v(n, s):
        return (rng.randn(n) * s).astype(np.float32)

    def bn(n):
        return (1.0 + 0.1 * rng.rand(n)).astype(np.float32), v(n, 0.05)

    lda = 3 * FEAT + ivector_dim
    s1, o1 = bn(dim)
    m = {"lda": {"w": w(lda, lda), "b": v(lda, 0.1)},
         "tdnn1": {"w": w(lda, dim), "b": v(dim, 0.1), "scale": s1,
                   "offset": o1},
         "tdnnf": [], "bypass": 0.66, "prefinal_l": {"w": w(dim, small)},
         "num_ceps": FEAT, "lifter": 22.0, "subsample": subsample}
    for s in strides:
        k = 2 if s else 1
        scale, offset = bn(dim)
        m["tdnnf"].append({"stride": s, "w_l": w(k * dim, neck),
                           "w_a": w(k * neck, dim), "b": v(dim, 0.1),
                           "scale": scale, "offset": offset})
    sa, oa = bn(dim)
    sb, ob = bn(small)
    m["prefinal_chain"] = {"w1": w(small, dim), "b1": v(dim, 0.1),
                           "scale1": sa, "offset1": oa, "w2": w(dim, small),
                           "scale2": sb, "offset2": ob}
    m["output"] = {"w": w(small, pdfs), "b": v(pdfs, 0.1)}
    return m


def nnet_spec(m: Dict) -> binfmt.NnetSpec:
    """The model as NN02 layers: splice (-1, 0, 1) + narrow, the i-vector,
    lda, tdnn1, the blocks with the subsample layer before the first
    whose stride the factor divides, prefinal-l, prefinal-chain, output."""
    spec = binfmt.LayerSpec
    layers = [spec(binfmt.LAYER_SPLICE, indices=(-1, 0, 1)),
              spec(binfmt.LAYER_NARROW, narrow_left=1, narrow_right=1),
              spec(binfmt.LAYER_IVECTOR,
                   dim=m["lda"]["w"].shape[0] - 3 * m["num_ceps"]),
              spec(binfmt.LAYER_LINEAR, weight=m["lda"]["w"],
                   bias=m["lda"]["b"])]
    t = m["tdnn1"]
    layers += [spec(binfmt.LAYER_LINEAR, weight=t["w"], bias=t["b"]),
               spec(binfmt.LAYER_RELU),
               spec(binfmt.LAYER_BATCHNORM, scale=t["scale"],
                    offset=t["offset"])]
    sub = m["subsample"] == 1
    for x in m["tdnnf"]:
        if not sub and x["stride"] % m["subsample"] == 0:
            layers.append(spec(binfmt.LAYER_SUBSAMPLE,
                               factor=m["subsample"]))
            sub = True
        layers.append(spec(binfmt.LAYER_TDNNF, stride=x["stride"],
                           bypass=m["bypass"], linear=x["w_l"],
                           affine=x["w_a"], bias=x["b"], scale=x["scale"],
                           offset=x["offset"]))
    p = m["prefinal_chain"]
    layers += [spec(binfmt.LAYER_SPLICED_LINEAR, offsets=(0,),
                    weight=m["prefinal_l"]["w"]),
               spec(binfmt.LAYER_LINEAR, weight=p["w1"], bias=p["b1"]),
               spec(binfmt.LAYER_RELU),
               spec(binfmt.LAYER_BATCHNORM, scale=p["scale1"],
                    offset=p["offset1"]),
               spec(binfmt.LAYER_SPLICED_LINEAR, offsets=(0,), weight=p["w2"]),
               spec(binfmt.LAYER_BATCHNORM, scale=p["scale2"],
                    offset=p["offset2"]),
               spec(binfmt.LAYER_LINEAR, weight=m["output"]["w"],
                    bias=m["output"]["b"])]
    c = ref.context(m)
    return binfmt.NnetSpec(c, c, layers)


def chain_graph(rng: np.random.RandomState, num_words: int = 40,
                num_phones: int = 12, variants: int = 2,
                phones: Tuple[int, int] = (2, 4)):
    """(FlatFst, tid2pdf [2 P + 1], num_pdfs, word pdf pairs): a word-loop
    prefix trie in chain topology.  A state per phone, entered by an arc
    emitting the phone's class-0 pdf and held by a self-loop emitting its
    class-1 pdf; a word's last phone leaves by an epsilon arc carrying
    the word back to the root, which is final.  tid 1 + 2 pdf + class."""
    children: Dict = {}
    parent: List[int] = []
    phone: List[int] = []
    words = []
    for w in range(1, num_words + 1):
        node, path = -1, []
        for p in rng.randint(0, num_phones, size=rng.randint(
                phones[0], phones[1] + 1)):
            e = children.get((node, int(p)))
            if e is None:
                e = children[(node, int(p))] = len(parent)
                parent.append(node)
                phone.append(int(p))
            node = e
            path.append(e)
        words.append(path)
    n = len(parent)
    variant = rng.randint(0, variants, size=n)
    pdf = np.array([[(ph * 2 + c) * variants + v for c in (0, 1)]
                    for ph, v in zip(phone, variant)], np.int64)
    state = 1 + np.arange(n)
    src = np.concatenate([np.where(np.asarray(parent) < 0, 0,
                                   state[np.maximum(parent, 0)]), state])
    dst = np.concatenate([state, state])
    ilab = np.concatenate([1 + 2 * pdf[:, 0], 2 + 2 * pdf[:, 1]])
    wgt = np.concatenate([rng.uniform(0.7, 1.5, n),
                          rng.uniform(0.3, 0.7, n)])
    last = np.array([p[-1] for p in words])
    # Homophones keep the first word's exit only.
    _, first = np.unique(last, return_index=True)
    src = np.concatenate([src, state[last[first]]])
    dst = np.concatenate([dst, np.zeros(first.size, np.int64)])
    ilab = np.concatenate([ilab, np.zeros(first.size, np.int64)])
    olab = np.concatenate([np.zeros(2 * n, np.int64), 1 + first])
    wgt = np.concatenate([wgt, rng.uniform(1.0, 3.0, first.size)])
    final = np.full(n + 1, np.inf, np.float32)
    final[0] = 0.0
    num_pdfs = 2 * num_phones * variants
    tid2pdf = np.concatenate([[0], np.arange(2 * num_pdfs) // 2]).astype(
        np.int32)
    fst = FlatFst.from_arrays(0, final, src, dst, ilab, olab,
                              wgt.astype(np.float32))
    pairs = {1 + int(i): pdf[words[i]] for i in first}
    return fst, tid2pdf, num_pdfs, pairs


def plant(rng: np.random.RandomState, pairs: Dict, num_pdfs: int,
          n_words: int, amp: float = 10.0) -> Tuple[np.ndarray, List[int]]:
    """[T, P] log-softmax(amp onehot + N(0, 1)) rows walking `n_words`
    random words, each phone 2-4 frames (class 0 first, then class 1)."""
    ids = sorted(pairs)
    truth = [ids[i] for i in rng.randint(0, len(ids), size=n_words)]
    targets = []
    for w in truth:
        for a, b in pairs[w]:
            targets += [a] + [b] * int(rng.randint(1, 4))
    z = rng.randn(len(targets), num_pdfs)
    z[np.arange(len(targets)), targets] += amp
    z -= z.max(axis=1, keepdims=True)
    return (z - np.log(np.exp(z).sum(axis=1, keepdims=True))).astype(
        np.float32), truth


def write_chain_model(out: str, rng: np.random.RandomState,
                      extra: str = "") -> Tuple[str, Dict, int]:
    """A chain model directory (pk::fst_0 graph, NN02 TDNN-F, tid2pdf,
    words, a config with am_scale 1.0 and MFCC features, no prior; the
    nnet subsamples by 3 and appends an i-vector); (config path, model,
    i-vector width)."""
    os.makedirs(out, exist_ok=True)
    fst, tid2pdf, num_pdfs, _ = chain_graph(rng)
    model = make_model(rng, pdfs=num_pdfs)
    spec = nnet_spec(model)
    with open(os.path.join(out, "graph.fst"), "wb") as fd:
        binfmt.write_pkfst(fd, fst.to_raw())
    with open(os.path.join(out, "am.nnet"), "wb") as fd:
        binfmt.write_nnet(fd, spec)
    with open(os.path.join(out, "am.tid2pdf"), "wb") as fd:
        binfmt.write_vec0(fd, tid2pdf)
    with open(os.path.join(out, "words.txt"), "w") as fd:
        fd.write("<eps> 0\n")
        fd.writelines(f"w{i} {i}\n" for i in range(1, 41))
        fd.write("<s> 41\n</s> 42\n")
    dim = spec.layers[2].dim
    conf = os.path.join(out, "chain.conf")
    with open(conf, "w") as fd:
        fd.write(f"fst = graph.fst\nnnet = am.nnet\ntid2pdf = am.tid2pdf\n"
                 f"symbol_table = words.txt\nleft_context = "
                 f"{spec.left_context}\nright_context = "
                 f"{spec.right_context}\nchunk_size = 20\nnum_pdfs = "
                 f"{num_pdfs}\nam_scale = 1.0\nfeature_type = mfcc\n"
                 f"beam_size = 256\nexpand_size = 4096\n" + extra)
    return conf, model, dim
