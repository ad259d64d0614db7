"""Times the port's decode route against the number of visible keys and
the batch, on one GPU.

    PYTHONPATH=src python scripts/torch_flash_bench.py

At the LM main path's decode shape (llama3.2-3b: H 24, KVH 8, D 128, a
2,080-slot cache) the ``decode`` route runs over 32, 256, 1,024 and
2,080 visible keys in bf16 and float32, and at batch 1 and 16 beside
``scaled_dot_product_attention`` (timed only).  Each output is first held
against the plain version; times are device time per launch from a CUDA
graph of 10 launches (``chip_smoke._kernel_ms``, as phase 17 times the
same kernels at batch 4).  The card's name and power limit head the
output.  Needs a CUDA GPU and ``nvcc``; exits non-zero without them.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

H, KVH, D, CACHE = 24, 8, 128, 2080
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def checked_ms(q, k, v, off) -> float:
    """The decode route at ``kv_offset = off``, held against the plain
    version, then timed."""
    def run():
        return fa.flash_decode_cuda(q, k, v, causal=True, scale=D ** -0.5,
                                    kv_offset=off)
    want = ref.flash_attention_ref(q, k, v, causal=True, kv_offset=off)
    torch.testing.assert_close(run().float(), want.float(),
                               atol=TOL[q.dtype], rtol=TOL[q.dtype])
    return cs._kernel_ms(run)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(f"[flash bench] {cs._gpu_line()}; torch {torch.__version__}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, dtype):
        return [torch.randn(s, generator=gen, device="cuda").to(dtype)
                for s in ((b, 1, H, D), (b, CACHE, KVH, D),
                          (b, CACHE, KVH, D))]

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv(cs.LM_BATCH, dtype)
        row = []
        for n_vis in (32, 256, 1024, CACHE):
            split = fa.decode_split(cs.LM_BATCH, KVH, H, n_vis, sms)
            row.append(f"{n_vis} keys {checked_ms(q, k, v, n_vis - 1):.4f} "
                       f"ms (split {split})")
        print(f"[flash bench] decode B {cs.LM_BATCH} {dtype}, visible "
              f"keys: " + ", ".join(row))
    for b in (1, 16):
        q, k, v = qkv(b, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = cs._kernel_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True))
        print(f"[flash bench] decode bf16 B {b}, {CACHE} keys: decode "
              f"{checked_ms(q, k, v, CACHE - 1):.4f} ms, SDPA {lib:.4f} ms "
              f"(CUDA graph of 10)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
