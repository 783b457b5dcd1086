"""Side-by-side timing of the two Hamming kernels against an earlier
version of their sources, in one process on one NVIDIA GPU.

    mkdir -p build/ab_parent          # any git-ignored directory
    git show <commit>:orb_slam2_map_tpu_torch/csrc/gated_nn.cu > build/ab_parent/gated_nn.cu
    git show <commit>:orb_slam2_map_tpu_torch/csrc/hamming.cu > build/ab_parent/hamming.cu
    python3 chip_ab.py build/ab_parent
    python3 chip_ab.py --timing-only build/ab_variant   # an ablated copy

The earlier sources must export the same C entries as the current ones:
    int gated_nn_launch(a, b, gate, idx, best, second, int n, int m, stream)
    int hamming_launch(a, b, out, int n, int m, stream)
Both versions are built with the same nvcc flags, checked equal to the
plain versions on the inputs of chip_smoke.py (the earlier one not with
--timing-only: a copy with parts of the kernel cut out, to see where its
time goes), and
timed in turns (earlier, current, current, earlier) with
chip_smoke._time_ms at chip_smoke.py's path shapes. Prints one line per
kernel and shape with both times, their ratio and each one's share of
the bound, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

import chip_smoke


def _parent_libs(parent: Path):
    from orb_slam2_map_tpu_torch.ops import cuda_build

    vp, ci = ctypes.c_void_p, ctypes.c_int
    gated = cuda_build.KernelLibrary(
        "gated_nn_parent", "gated_nn_launch", [vp] * 6 + [ci, ci, vp],
        source=parent / "gated_nn.cu")
    hamming = cuda_build.KernelLibrary(
        "hamming_parent", "hamming_launch", [vp] * 3 + [ci, ci, vp],
        source=parent / "hamming.cu")
    return gated, hamming


def main(argv):
    timing_only = "--timing-only" in argv
    argv = [a for a in argv if a != "--timing-only"]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    from orb_slam2_map_tpu_torch.ops import (cuda_build, gated_nn_cuda,
                                             hamming_cuda, matching)

    device, card = chip_smoke.phase_device()
    gated_old, hamming_old = _parent_libs(Path(argv[1]).resolve())
    libs = [gated_nn_cuda.LIB, hamming_cuda.LIB, gated_old, hamming_old]
    cuda_build.build_all(libs)
    for lib in libs:
        print(f"[ab] built {lib.source.parent.name}/{lib.source.name}: "
              f"{lib.ptxas_summary()}")
    stream = cuda_build.stream_of(device)

    def gated_parent(a, b, gate):
        n, m = gate.shape
        out = (torch.empty(n, dtype=torch.int32, device=device),
               torch.empty(n, device=device), torch.empty(n, device=device))
        if gated_old.fn()(a.data_ptr(), b.data_ptr(), gate.data_ptr(),
                          *(t.data_ptr() for t in out), n, m, stream):
            raise RuntimeError("earlier gated_nn launch failed")
        return out

    def hamming_parent(a, b):
        out = torch.empty((a.shape[0], b.shape[0]), device=device)
        if hamming_old.fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            a.shape[0], b.shape[0], stream):
            raise RuntimeError("earlier hamming launch failed")
        return out

    def compare(name, shape, old, new, bound_ms):
        o1 = chip_smoke._time_ms(old)
        n1 = chip_smoke._time_ms(new)
        n2 = chip_smoke._time_ms(new)
        o2 = chip_smoke._time_ms(old)
        o, n = min(o1, o2), min(n1, n2)
        print(f"[ab] {name} [{shape[0]}x{shape[1]}] earlier {o:.4f} ms "
              f"({o1:.4f}/{o2:.4f}), current {n:.4f} ms ({n1:.4f}/{n2:.4f}), "
              f"{o / n:.2f}x faster; bound {bound_ms:.5f} ms: "
              f"{100 * bound_ms / o:.1f} % -> {100 * bound_ms / n:.1f} % of it "
              f"| {card}")

    for i, (n, m) in enumerate(chip_smoke.GATED_SHAPES):
        a, b, gate, _ = chip_smoke._gated_exact(n, m, 100 + i, device)
        got = gated_parent(a, b, gate)
        torch.cuda.synchronize()
        for x, y in zip(got, matching.gated_nn_plain(a, b, gate)):
            if not timing_only and not torch.equal(x, y):
                raise AssertionError(f"earlier gated_nn != plain at [{n}x{m}]")
        bound_ms, _ = chip_smoke._bound((n + m) * 32 + n * m + n * 12,
                                        2 * 256 * int(gate.sum()))
        compare("gated_nn", (n, m), lambda: gated_parent(a, b, gate),
                lambda: gated_nn_cuda.gated_nn(a, b, gate), bound_ms)
    for i, (n, m) in enumerate(chip_smoke.HAMMING_SHAPES):
        a, b, ref, _ = chip_smoke._hamming_exact(n, m, 200 + i, device)
        got = hamming_parent(a, b)
        torch.cuda.synchronize()
        if not timing_only and not torch.equal(got, ref):
            raise AssertionError(f"earlier hamming != plain at [{n}x{m}]")
        bound_ms, _ = chip_smoke._bound((n + m) * 32 + n * m * 4,
                                        2 * 256 * n * m)
        compare("hamming", (n, m), lambda: hamming_parent(a, b),
                lambda: hamming_cuda.hamming_matrix(a, b), bound_ms)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
