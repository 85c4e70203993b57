"""PyTorch + CUDA port of the DiskANN vector search engine.

Mirrors the layout of `opensearch_jvector_tpu` (ops/, models/, index/,
api/, utils/) so each module's counterpart sits at the same relative path.
Plain tensor code is PyTorch; the fused ADC scan is a hand-written CUDA
kernel (`csrc/adc_scan.cu`, bound in `ops/adc_kernel.py`).

Numerics contract: every float32 matrix product in this package runs in
full float32. LUT builds, the encode argmin and the exact rerank match the
reference's `preferred_element_type=f32` paths, so TF32 is switched off for
matmuls and convolutions alike when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
