"""Parity of the port's place recognition (place/vocabulary.py,
place/database.py) against the JAX package: the shipped vocabulary file,
the tree descent, BoW vectors, training, the DBoW2 converters, and the
keyframe database's loop / relocalization candidates on one map carried
into both packages (MapStore.load_arrays). Every output here is an
integer or a selection, or float arithmetic done the same way in numpy
on both sides, so everything is held exactly.
"""

import hashlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_map_tpu.config import SystemConfig as JSystemConfig
from orb_slam2_map_tpu.place import database as jdb
from orb_slam2_map_tpu.place import vocabulary as jvoc
from orb_slam2_map_tpu.slam.mapstore import MapStore as JMapStore
from orb_slam2_map_tpu_torch.ops import matching as tmatching
from orb_slam2_map_tpu_torch.place import database as tdb
from orb_slam2_map_tpu_torch.place import vocabulary as tvoc
from orb_slam2_map_tpu_torch.slam.mapstore import MapStore as TMapStore

from test_torch_orb import port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def descs():
    """Clustered binary descriptors (20 clusters x 100 perturbed copies,
    the JAX package's test_place.py recipe), every third row with its
    top bits set."""
    rng = np.random.default_rng(0)
    centers = rng.integers(0, 2 ** 32, (20, 8), dtype=np.uint32)
    centers[::3] |= np.uint32(0x80000000)
    out = []
    for c in centers:
        bits = np.unpackbits(c.view(np.uint8))
        for _ in range(100):
            b = bits.copy()
            b[rng.choice(256, 10, replace=False)] ^= 1
            out.append(np.packbits(b).view(np.uint32))
    return np.asarray(out)


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_shipped_vocabulary_is_a_byte_copy():
    j = os.path.join(REPO, "orb_slam2_map_tpu", "place", "data",
                     "vocab10k.npz")
    assert tdb.DEFAULT_VOCABULARY == os.path.join(
        REPO, "orb_slam2_map_tpu_torch", "place", "data", "vocab10k.npz")
    assert _sha256(tdb.DEFAULT_VOCABULARY) == _sha256(j)
    tv, jv = tdb.load_default_vocabulary(), jdb.load_default_vocabulary()
    assert (tv.k, tv.L, tv.levelsup) == (jv.k, jv.L, jv.levelsup)
    assert tv.n_words == 10000
    np.testing.assert_array_equal(tv.centroids, jv.centroids)
    np.testing.assert_array_equal(tv.weights, jv.weights)


def test_transform_and_bow_exact(descs):
    """The shipped tree: words, direct-index nodes, sparse and dense BoW
    on descriptors with top-bit words, numpy and tensor inputs."""
    tv, jv = tdb.load_default_vocabulary(), jdb.load_default_vocabulary()
    rng = np.random.default_rng(1)
    d = np.concatenate([descs[rng.choice(len(descs), 600)],
                        rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint32)])
    d[::4, 7] |= np.uint32(0x80000000)
    valid = rng.uniform(size=len(d)) < 0.9
    wj, nj = jv.transform(d, valid)
    wt, nt = tv.transform(d, valid, device="cpu")
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(nt, nj)
    wt2, _ = tv.transform(torch.as_tensor(d.view(np.int32)), valid)
    np.testing.assert_array_equal(wt2, wj)
    for a, b in zip(tv.bow_sparse(d, valid, "cpu"), jv.bow_sparse(d, valid)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tv.bow_vector(d, valid, "cpu"),
                                  jv.bow_vector(d, valid))
    w1, v1 = tv.bow_sparse(d[:300], device="cpu")
    w2, v2 = tv.bow_sparse(d[200:500], device="cpu")
    assert tvoc.Vocabulary.score_sparse(w1, v1, w2, v2) == \
        jvoc.Vocabulary.score_sparse(w1, v1, w2, v2)


def test_popcount_top_bits():
    """The host popcount and the device Hamming distance the tree descent
    uses, on words with the top bit set, against the JAX package's."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    np.testing.assert_array_equal(tmatching.popcount_np(x),
                                  jvoc._popcount_np(x))
    a, b = x[:2048].reshape(256, 8), x[2048:].reshape(256, 8)
    got = tmatching.hamming_distance(torch.as_tensor(a.view(np.int32)),
                                     torch.as_tensor(b.view(np.int32)))
    np.testing.assert_array_equal(
        got.numpy(), np.diagonal(jvoc.hamming_np(a, b)))
    np.testing.assert_array_equal(tvoc.hamming_np(a, b), jvoc.hamming_np(a, b))


def test_train_vocabulary_exact(descs, tmp_path):
    tv = tvoc.train_vocabulary(descs, k=5, L=2, seed=1)
    jv = jvoc.train_vocabulary(descs, k=5, L=2, seed=1)
    np.testing.assert_array_equal(tv.centroids, jv.centroids)
    np.testing.assert_array_equal(tv.weights, jv.weights)
    assert tv.levelsup == jv.levelsup
    np.testing.assert_array_equal(tv.transform(descs, device="cpu")[0],
                                  jv.transform(descs)[0])
    # save / load round trip through either package
    tv.save(str(tmp_path / "v.npz"))
    back = jvoc.Vocabulary.load(str(tmp_path / "v.npz"))
    np.testing.assert_array_equal(back.centroids, tv.centroids)


def test_converters_exact(tmp_path):
    """DBoW2 text and binary formats: the port writes the JAX package's
    bytes and reads them back to the same tree; synthesized trees agree."""
    tv = tvoc.synthesize_vocabulary(4, 3, seed=7)
    jv = jvoc.synthesize_vocabulary(4, 3, seed=7)
    np.testing.assert_array_equal(tv.centroids, jv.centroids)
    np.testing.assert_array_equal(tv.weights, jv.weights)
    for save_t, save_j, load_t, ext in (
            (tvoc.save_orbvoc_text, jvoc.save_orbvoc_text,
             tvoc.load_orbvoc_text, "txt"),
            (tvoc.save_orbvoc_binary, jvoc.save_orbvoc_binary,
             tvoc.load_orbvoc_binary, "bin")):
        pt, pj = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
        save_t(tv, pt)
        save_j(jv, pj)
        assert _sha256(pt) == _sha256(pj)
        back = load_t(pj)
        np.testing.assert_array_equal(back.centroids, tv.centroids)
        if ext == "bin":
            np.testing.assert_array_equal(back.weights, tv.weights)


def _carried_map(descs, seed=4, K=12, N=64):
    """A JAX MapStore of K keyframes with a revisit (keyframe 9 sees
    keyframe 1's descriptors) and a covisibility chain, and the port's
    MapStore holding the same arrays."""
    rng = np.random.default_rng(seed)
    jm = JMapStore(max_keyframes=16, max_points=512, kp_capacity=N)
    scenes = [descs[rng.choice(len(descs), N)] for _ in range(K)]
    scenes[9] = scenes[1].copy()
    scenes[9][::5] = descs[rng.choice(len(descs), len(scenes[9][::5]))]
    for kid in range(K):
        jm.alloc_keyframe()
        jm.kf_desc[kid] = scenes[kid]
        jm.kf_kp_valid[kid] = rng.uniform(size=N) < 0.95
        jm.kf_frame_id[kid] = 30 * kid
        jm.version += 1
    for a in range(K - 1):          # consecutive keyframes are covisible
        jm.covis[a, a + 1] = jm.covis[a + 1, a] = 40 - a
        if a + 2 < K:
            jm.covis[a, a + 2] = jm.covis[a + 2, a] = 20
    tm = TMapStore(16, 512, N)
    tm.load_arrays({k: getattr(jm, k) for k in (
        *TMapStore._STATE_FIELDS, "_next_kf", "_next_mp", "kf_origin",
        "version", "loop_edges")})
    return jm, tm


def test_keyframe_database_exact(descs):
    """Loop and relocalization candidates, minScore, culling a keyframe,
    clear and rebuild: the same answers from both packages' databases on
    one carried-across map."""
    cfg = JSystemConfig()
    jm, tm = _carried_map(descs)
    voc_j = jvoc.train_vocabulary(descs, k=5, L=3, seed=2)
    voc_t = tvoc.Vocabulary(k=voc_j.k, L=voc_j.L,
                            centroids=voc_j.centroids.copy(),
                            weights=voc_j.weights.copy(),
                            levelsup=voc_j.levelsup)
    dj = jdb.KeyFrameDatabase(cfg, jm, vocabulary=voc_j)
    dt = tdb.KeyFrameDatabase(port_config(cfg), tm, vocabulary=voc_t,
                              device="cpu")

    def same(label):
        for kid in range(12):
            if not jm.kf_exists[kid]:
                continue
            assert dt.min_score_vs_neighbors(kid) == \
                dj.min_score_vs_neighbors(kid), (label, kid)
            for ms in (0.0, 0.05, 0.2):
                np.testing.assert_array_equal(
                    dt.detect_loop_candidates(kid, ms),
                    dj.detect_loop_candidates(kid, ms), err_msg=label)
        rng = np.random.default_rng(3)
        for src in (1, 5, 9):
            q = jm.kf_desc[src].copy()
            q[::3] = descs[rng.choice(len(descs), len(q[::3]))]
            ones = np.ones(len(q), bool)

            class JF:
                desc = jnp.asarray(q)
                valid = jnp.asarray(ones)

            class TF:
                desc = torch.as_tensor(q.view(np.int32))
                valid = torch.as_tensor(ones)

            np.testing.assert_array_equal(dt.reloc_candidates(TF),
                                          dj.reloc_candidates(JF),
                                          err_msg=label)

    same("initial")
    assert 1 in dt.detect_loop_candidates(9, 0.01).tolist()
    for m in (jm, tm):
        m.kf_exists[3] = False
        m.version += 1
    same("keyframe 3 culled")
    dt.rebuild()
    dj.rebuild()
    same("rebuilt")
    dt.clear()
    assert not dt._has_bow.any() and not dt._inv


def test_default_vocabulary_loads_lazily():
    """Without a vocabulary the database loads the shipped one once the
    map has four keyframes, as the JAX package's does."""
    cfg = port_config(JSystemConfig())
    tm = TMapStore(8, 64, 32)
    db = tdb.KeyFrameDatabase(cfg, tm, device="cpu")
    for kid in range(3):
        tm.alloc_keyframe()
        tm.version += 1
    db.maybe_refresh()
    assert db.vocab is None
    tm.alloc_keyframe()
    tm.version += 1
    db.maybe_refresh()
    assert db.vocab is tdb.load_default_vocabulary()
    assert db._has_bow[:4].all()


def test_place_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import orb_slam2_map_tpu_torch.place, "
            "orb_slam2_map_tpu_torch.place.database; "
            "assert 'orb_slam2_map_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
