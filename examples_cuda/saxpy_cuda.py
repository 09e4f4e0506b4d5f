"""SAXPY + dot via transform_reduce on the CUDA executor — config #1.

Reference analog: hpx::transform_reduce with execution::par
(libs/core/algorithms), the north-star spelling:
`par.on(cuda_executor())` reroutes the whole algorithm to the card.
Counterpart of examples/saxpy_tpu.py.

Usage: python3 examples_cuda/saxpy_cuda.py [log2_n] [--cpu]

Runs on cuda:0 (``--cpu`` asks for the CPU instead) and checks the
result against float64 numpy: z = a*x + y within 2.5e-7 relative (two
float32 roundings, 2^-24 each), dot(z, x) within 1e-5 relative (torch's
tree-shaped float32 sum, whose error grows about as log2(n)·2^-24).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hpx_tpu_torch as hpx  # noqa: E402

Z_RTOL = 2.5e-7
DOT_RTOL = 1e-5


def saxpy_dot(policy, x, y, a):
    """z = a*x + y (two transforms), then dot(z, x) (transform_reduce) —
    the composed saxpy+dot of BASELINE config #1, every step through the
    policy."""
    z = hpx.transform(policy, x, lambda xi: a * xi)     # scale
    z = hpx.transform(policy, z, torch.add, rng2=y)     # + y
    dot = hpx.transform_reduce(policy, z, 0.0, torch.add, torch.mul,
                               rng2=x)
    return z, dot


def inputs(n: int, device):
    """x and y uniform in [0, 1) from numpy seed 0, on ``device``."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random(n, np.float32)).to(device)
    y = torch.from_numpy(rng.random(n, np.float32)).to(device)
    return x, y


def reference(x, y, a):
    """(z, dot) in float64 numpy from the float32 inputs."""
    x64 = x.cpu().numpy().astype(np.float64)
    z64 = a * x64 + y.cpu().numpy().astype(np.float64)
    return z64, float(np.dot(z64, x64))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a != "--cpu"]
    n = 1 << (int(argv[0]) if argv else 22)
    ex = hpx.cuda_executor(device=device)
    x, y = inputs(n, ex.target.device)
    a = 2.5
    policy = hpx.par.on(ex)

    z, dot = saxpy_dot(policy, x, y, a)
    z64, dot64 = reference(x, y, a)
    np.testing.assert_allclose(z.cpu().numpy(), z64, rtol=Z_RTOL)
    np.testing.assert_allclose(float(dot), dot64, rtol=DOT_RTOL)

    t = hpx.HighResolutionTimer()
    reps = 10
    for _ in range(reps):
        z = hpx.transform(policy, z, torch.add, rng2=y)
    float(z[0])
    per = t.elapsed() / reps
    gbs = 3 * n * 4 / per / 1e9
    print(f"n = {n} on {ex.target.device}: dot(saxpy) = {float(dot):.2f} "
          f"(float64: {dot64:.2f})")
    print(f"streaming add: {gbs:.1f} GB/s effective")
    return 0


if __name__ == "__main__":
    sys.exit(main())
