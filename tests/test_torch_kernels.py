"""The hand-written CUDA kernels against their plain PyTorch versions
(ops/matching.py: gated_nn_plain, hamming_matrix_plain), and the
wrappers' checks.

This file imports torch, numpy and the port only, so it also runs on a
machine without JAX. The kernels have no CPU mode: their tests are marked
`cuda` and skip without a card. On the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest imports JAX.)
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from orb_slam2_map_tpu_torch.ops import cuda_build, gated_nn_cuda, hamming_cuda
from orb_slam2_map_tpu_torch.ops import matching as tm

torch.set_num_threads(1)

GATE_KINDS = ["random30", "window", "rows_all_gated", "single_key", "open"]


def _t(a):
    a = np.array(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _descs(rng, n, m):
    """Random packed descriptors with top-bit words, duplicated keys
    (ties) and queries equal to keys (zero distance)."""
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    a[::3, 0] |= np.uint32(0x80000000)
    a[1] = 0xFFFFFFFF
    b[4::9] = b[2:2 + len(b[4::9])]
    a[::5] = b[rng.integers(0, m, len(a[::5]))]
    return a, b


def _gate(kind, rng, n, m):
    if kind == "random30":
        return rng.uniform(size=(n, m)) < 0.3
    if kind == "window":
        q, k = rng.uniform(0, 320, (n, 2)), rng.uniform(0, 320, (m, 2))
        return (np.abs(q[:, None] - k[None]) <= 40.0).all(-1)
    if kind == "rows_all_gated":
        g = rng.uniform(size=(n, m)) < 0.5
        g[::4] = False
        return g
    if kind == "single_key":
        g = np.zeros((n, m), bool)
        g[np.arange(n), rng.integers(0, m, n)] = True
        return g
    return np.ones((n, m), bool)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(1)
    a, b = _descs(rng, 8, 8)
    with pytest.raises(ValueError):
        gated_nn_cuda.gated_nn(_t(a), _t(b), torch.ones(8, 8, dtype=torch.bool))


def test_hamming_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(1)
    a, b = _descs(rng, 8, 8)
    before = hamming_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        hamming_cuda.hamming_matrix(_t(a), _t(b))
    assert hamming_cuda.LAUNCHES == before


def test_plain_version_semantics():
    """Row by row against a direct numpy evaluation of the contract:
    lowest column at the best distance (0 when all gated), second-best
    over the other columns capped at 1e9."""
    rng = np.random.default_rng(2)
    a, b = _descs(rng, 40, 23)
    gate = _gate("rows_all_gated", rng, 40, 23)
    idx, best, second = (x.numpy() for x in
                         tm.gated_nn_plain(_t(a), _t(b), _t(gate)))
    d = np.unpackbits((a[:, None, :] ^ b[None, :, :]).view(np.uint8),
                      axis=-1).sum(-1).astype(np.float32)
    d = np.where(gate, d, 1e9)
    for i in range(len(a)):
        want_idx = int(np.argmin(d[i])) if d[i].min() < 1e9 else 0
        assert idx[i] == want_idx and best[i] == d[i].min()
        assert second[i] == np.delete(d[i], want_idx).min()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GATE_KINDS)
def test_gated_nn_kernel_on_card(cuda_device, kind):
    rng = np.random.default_rng(GATE_KINDS.index(kind))
    for n, m in ((1032, 1032), (4096, 1032), (37, 1500), (5, 1)):
        a, b = _descs(rng, n, m)
        gate = _t(_gate(kind, rng, n, m)).to(cuda_device)
        a, b = _t(a).to(cuda_device), _t(b).to(cuda_device)
        before = gated_nn_cuda.LAUNCHES
        got = gated_nn_cuda.gated_nn(a, b, gate)
        torch.cuda.synchronize()
        assert gated_nn_cuda.LAUNCHES == before + 1
        for g, w in zip(got, tm.gated_nn_plain(a, b, gate)):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2040, 2040), (424, 424), (37, 1500),
                                   (5, 1), (0, 8)])
def test_hamming_kernel_on_card(cuda_device, shape):
    n, m = shape
    rng = np.random.default_rng(n + m)
    a, b = _descs(rng, max(n, 2), max(m, 2))
    a = _t(a[:n]).to(cuda_device)
    b = _t(b[:m]).to(cuda_device)
    before = hamming_cuda.LAUNCHES
    got = hamming_cuda.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert hamming_cuda.LAUNCHES == before + (1 if n and m else 0)
    assert got.shape == (n, m) and got.dtype == torch.float32
    assert torch.equal(got, tm.hamming_matrix_plain(a, b))
    # the entry point launches the kernel on CUDA tensors
    assert torch.equal(tm.hamming_matrix(a, b), got)


# --- the tensor-core design's arithmetic, modelled in numpy (CPU) --------
# csrc/hamming_mma.cuh and csrc/gated_nn.cu; the card tests below run the
# kernels themselves.

def _pm1(w, shift):
    """hamming_mma::pm1: four bits (t + 8i) of w -> four +-1 int8."""
    y = ((w.astype(np.uint64) >> np.uint64(shift)) & 0x01010101) * 0xFE \
        + 0x01010101
    return (y & 0xFFFFFFFF).astype(np.uint32).view(np.int8)


def test_fragment_bit_map_covers_every_bit_once():
    """The m16n8k32 k-slots of a quad (4t..4t+3 and 16+4t..16+4t+3 in
    both fragments) with the header's bit map give (256 - a.b) / 2 =
    popcount(a ^ b) for every pair, top-bit words included."""
    rng = np.random.default_rng(5)
    a, b = _descs(rng, 24, 20)
    dot = np.zeros((24, 20), np.int64)
    for s in range(8):
        for t in range(4):
            for shift in (t, t + 4):
                qa = _pm1(a[:, s], shift).reshape(24, 4).astype(np.int64)
                kb = _pm1(b[:, s], shift).reshape(20, 4).astype(np.int64)
                dot += qa @ kb.T
    want = tm.hamming_matrix_plain(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal((256 - dot) / 2, want)


def _merge(x, y):
    b = np.minimum(x[0], y[0])
    s = np.minimum(np.minimum(x[1], y[1]), np.maximum(x[0], y[0]))
    return b, s


@pytest.mark.parametrize("kind", GATE_KINDS)
def test_packed_key_reduction_matches_plain(kind):
    """gated_nn.cu's epilogue: keys (d << 22 | j) + 2^31 if closed, built
    from the accumulator with one multiply-add, folded as (best, second)
    in a scrambled column order and merged across splits, decode to the
    plain version's (idx, best, second)."""
    rng = np.random.default_rng(10 + GATE_KINDS.index(kind))
    n, m = 37, 150
    a, b = _descs(rng, n, m)
    gate = _gate(kind, rng, n, m)
    acc = (256 - 2 * tm.hamming_matrix_plain(_t(a), _t(b)).numpy()
           ).astype(np.int64)
    j = np.arange(m, dtype=np.uint64)
    base = (j + 0xA0000000) ^ (gate.astype(np.uint64) << np.uint64(31))
    keys = ((base + (acc.astype(np.uint64) * 0xFFE00000)) & 0xFFFFFFFF)
    none = np.full(n, 0xFFFFFFFF, np.uint64)
    parts = []
    for cols in np.array_split(rng.permutation(m), 5):    # splits
        st = (none.copy(), none.copy())
        for c in cols:                                     # any order
            v = keys[:, c]
            st = (np.minimum(st[0], v),
                  np.minimum(st[1], np.maximum(st[0], v)))
        parts.append(st)
    best, second = none, none
    for p in reversed(parts):
        best, second = _merge((best, second), p)
    closed = best >= 2 ** 31
    idx = np.where(closed, 0, best & (2 ** 22 - 1)).astype(np.int32)
    bestf = np.where(closed, 1e9, best >> np.uint64(22)).astype(np.float32)
    secondf = np.where(second >= 2 ** 31, 1e9,
                       second >> np.uint64(22)).astype(np.float32)
    widx, wbest, wsecond = (x.numpy() for x in
                            tm.gated_nn_plain(_t(a), _t(b), _t(gate)))
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_array_equal(bestf, wbest)
    np.testing.assert_array_equal(secondf, wsecond)


def test_library_key_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header changes the library's build key, so
    a kernel that includes it is rebuilt rather than loaded stale."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    for name in ("gated_nn", "hamming"):
        assert '#include "hamming_mma.cuh"' in (csrc / f"{name}.cu").read_text()
    libs = [cuda_build.KernelLibrary(name, f"{name}_launch", [],
                                     source=csrc / f"{name}.cu")
            for name in ("gated_nn", "hamming")]
    before = [lib.library_path() for lib in libs]
    assert [p.parent for p in before] == [tmp_path / "build"] * 2
    assert before == [lib.library_path() for lib in libs]   # stable
    header = csrc / "hamming_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [lib.library_path() for lib in libs]
    assert all(x != y for x, y in zip(before, after))


# --- the kernels on the card ----------------------------------------------

RAGGED_N = [1, 15, 17, 1031]
RAGGED_M = [1, 7, 9, 1033, 2041]


def _mixed_gate(rng, n, m):
    """Random 30 % rows, then all-closed rows, then all-open rows."""
    g = rng.uniform(size=(n, m)) < 0.3
    g[n // 3:(2 * n) // 3] = False
    g[(2 * n) // 3:] = True
    return g


def _check_gated(a, b, gate, device):
    a, b, gate = (_t(x).to(device) for x in (a, b, gate))
    before = gated_nn_cuda.LAUNCHES
    got = gated_nn_cuda.gated_nn(a, b, gate)
    torch.cuda.synchronize()
    assert gated_nn_cuda.LAUNCHES == before + (1 if a.shape[0] else 0)
    for g, w in zip(got, tm.gated_nn_plain(a, b, gate)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("m", RAGGED_M)
def test_gated_nn_ragged_on_card(cuda_device, n, m):
    rng = np.random.default_rng(1000 * n + m)
    a, b = _descs(rng, max(n, 2), m)
    a = a[:n]
    _check_gated(a, b, _mixed_gate(rng, n, m), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 1031])
def test_gated_nn_no_keys_on_card(cuda_device, n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    _check_gated(a, np.zeros((0, 8), np.uint32), np.zeros((n, 0), bool),
                 cuda_device)


@pytest.mark.cuda
def test_gated_nn_ties_and_top_bits_on_card(cuda_device):
    """Queries equal to keys, every key duplicated (ties at the best
    distance: lowest column, second == best), all-ones words."""
    rng = np.random.default_rng(7)
    b = rng.integers(0, 2 ** 32, (520, 8), dtype=np.uint32)
    b[260:] = b[:260]
    b[::13] = 0xFFFFFFFF
    a = np.concatenate([b[:200], b[::-3], np.full((5, 8), 0xFFFFFFFF,
                                                  np.uint32)])
    _check_gated(a, b, np.ones((len(a), len(b)), bool), cuda_device)
    _check_gated(a, b, _mixed_gate(rng, len(a), len(b)), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1031, 2041), (4096, 2040), (40, 4104)])
def test_gated_nn_split_merge_on_card(cuda_device, shape):
    """Shapes whose key range the kernel splits across the blocks of a
    cluster (merged through distributed shared memory)."""
    n, m = shape
    gated_nn_cuda.LIB.fn()
    lib = ctypes.CDLL(str(gated_nn_cuda.LIB.library_path()))
    lib.gated_nn_splits.argtypes = [ctypes.c_int, ctypes.c_int]
    assert lib.gated_nn_splits(n, m) > 1
    rng = np.random.default_rng(n + m)
    a, b = _descs(rng, n, m)
    for kind in ("random30", "window"):
        _check_gated(a, b, _gate(kind, rng, n, m), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("m", RAGGED_M)
def test_hamming_ragged_on_card(cuda_device, n, m):
    rng = np.random.default_rng(1000 * n + m)
    a, b = _descs(rng, max(n, 2), m)
    a = a[:n]
    a, b = _t(a).to(cuda_device), _t(b).to(cuda_device)
    got = hamming_cuda.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, tm.hamming_matrix_plain(a, b))
