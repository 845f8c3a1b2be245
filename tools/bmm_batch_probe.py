#!/usr/bin/env python3
"""Does a batched product's slice keep its bits as the batch grows?

    python3 tools/bmm_batch_probe.py        # on a CUDA GPU

For each product of one training step at full width (the EVAE's forward
products, and their input and weight gradients, at batch 64 rows), prints
whether slice 0 of ``torch.bmm`` is bit-identical at batch 1 and 2, at 2
and 4, and equal to the 2-D product, under the default BLAS and with
cuBLASLt and cuBLAS preferred.  The multiseed trainer batches its products
over seeds; a serial run is a batch of one.
"""

import json

import torch

# (rows, k, n) of the forward products; the step also forms g @ w^T and
# x^T @ g of each
FORWARD = [(64, 50, 256), (64, 256, 128), (64, 128, 4), (64, 2, 128),
           (64, 128, 128), (64, 128, 50)]


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for m, k, n in FORWARD:
        shapes += [("fwd", m, k, n), ("dx", m, n, k), ("dw", k, m, n)]
    out = {"device": torch.cuda.get_device_name(0)}
    for lib in ("default", "cublaslt", "cublas"):
        if lib != "default":
            torch.backends.cuda.preferred_blas_library(lib)
        res = {}
        for tag, m, k, n in shapes:
            a = torch.randn(4, m, k, device="cuda", generator=g)
            b = torch.randn(4, k, n, device="cuda", generator=g)
            r1 = torch.bmm(a[:1], b[:1])[0]
            r2 = torch.bmm(a[:2], b[:2])[0]
            r4 = torch.bmm(a, b)[0]
            res[f"{tag}_{m}x{k}x{n}"] = {
                "batch1_eq_batch2": bool(torch.equal(r1, r2)),
                "batch2_eq_batch4": bool(torch.equal(r2, r4)),
                "batch1_eq_mm": bool(torch.equal(a[0] @ b[0], r1))}
        out[lib] = res
    print(json.dumps(out))


if __name__ == "__main__":
    main()
