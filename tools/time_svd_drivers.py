"""Time ``torch.linalg.svd``'s cuSOLVER drivers on the low-rank codec's
shapes.

    python3 tools/time_svd_drivers.py [--rank 4]

A ViT-Tiny ``fedpac_soap_light`` round takes the thin SVD of every
client's SOAP factors — stacks of (5, m, m) for m in 192, 576, 768 — and
``lowrank_svd`` keeps the top ``rank`` triplets.  For each shape and each
driver (the default, ``gesvd``, ``gesvdj``, ``gesvda``) this prints the
mean time of a call (CUDA-synchronised host clock, after a warm-up call)
and the rank-r reconstruction's largest error against a float64 SVD on
the CPU, relative to the largest entry, on three inputs: an
ill-conditioned SPD factor (``X Xᵀ / 64 + 1e-3 I``, as SOAP's L and R
are), a rank-2 matrix (fewer nonzero singular values than the rank) and
zeros; a driver that raises on an input is reported as such.  Needs a
CUDA device; imports nothing of JAX.
"""
import argparse
import subprocess
import sys
import time

import torch

DRIVERS = (None, "gesvd", "gesvdj", "gesvda")


def inputs(m, gen):
    x = torch.randn((5, m, 64), generator=gen, device="cuda")
    spd = x @ x.transpose(1, 2) / 64 + 1e-3 * torch.eye(m, device="cuda")
    y = torch.randn((5, m, 2), generator=gen, device="cuda")
    return {"spd": spd, "rank2": y @ y.transpose(1, 2),
            "zeros": torch.zeros((5, m, m), device="cuda")}


def truncated(u, s, vt, r):
    return (u[..., :r] * s[..., None, :r]) @ vt[..., :r, :]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_svd_drivers: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = args.rank
    for m in (192, 576, 768):
        for kind, a in inputs(m, gen).items():
            want = truncated(*torch.linalg.svd(a.double().cpu(),
                                               full_matrices=False), r)
            scale = max(float(want.abs().max()), 1e-30)
            for drv in DRIVERS:
                head = f"(5, {m}, {m}) {kind:5s} driver={str(drv):6s}"
                try:
                    torch.linalg.svd(a, full_matrices=False, driver=drv)
                except torch.linalg.LinAlgError as e:
                    print(f"{head} raises: {str(e).splitlines()[0]}")
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    u, s, vt = torch.linalg.svd(a, full_matrices=False,
                                                driver=drv)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 3 * 1e3
                got = truncated(u, s, vt, r).double().cpu()
                err = float((got - want).abs().max()) / scale
                print(f"{head} {ms:8.2f} ms  rank-{r} max err / max|A_r| "
                      f"{err:.2e}  finite {bool(torch.isfinite(got).all())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
