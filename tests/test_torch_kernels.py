"""The hand-written gated-NN CUDA kernel against its plain PyTorch
version (ops/matching.py:gated_nn_plain), and the wrapper's checks.

This file imports torch, numpy and the port only, so it also runs on a
machine without JAX. The kernel has no CPU mode: its test is marked
`cuda` and skips without a card. On the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from orb_slam2_map_tpu_torch.ops import gated_nn_cuda
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
        pytest.skip("needs a CUDA card: the gated-NN kernel has no CPU mode")
    return torch.device("cuda")


def test_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(1)
    a, b = _descs(rng, 8, 8)
    with pytest.raises(ValueError):
        gated_nn_cuda.gated_nn(_t(a), _t(b), torch.ones(8, 8, dtype=torch.bool))


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
