"""Seeded-bad fixture: shared-memory budget and kernel-shape true
positives (``GRAFTCHECK_TORCH_SMEM_AUDIT``).

- a decode ring of four bf16 stages at head dim 256: 270,336 bytes of
  dynamic shared memory, over the H100's 232,448 a block
  (``smem-budget``);
- a preset at head dim 96 (12 heads of a 1152-wide model), which no
  kernel instantiates (``kernel-shape-unsupported``).
"""
from k8s_gpu_scheduler_tpu_torch.analysis.smem import KernelEntry, Preset

# decode_smem_bytes' ring with 4 stages: K and V, 64 rows of hd + 8.
RING_4_STAGES_HD256 = 2 * 2 * 4 * 64 * (256 + 8)

GRAFTCHECK_TORCH_SMEM_AUDIT = [
    ("decode ring, 4 stages at hd 256", KernelEntry(
        "K1", "decode_mma.cu", "decode_mma_kernel",
        ("__nv_bfloat16", "256", "PagedRows", "4"), RING_4_STAGES_HD256,
        ("decode_mma_smem_bytes", (0, 256, 0)))),
    ("hd 96", Preset("hd96", 12, 12, 96)),
]
