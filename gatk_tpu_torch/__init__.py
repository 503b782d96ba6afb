"""gatk_tpu_torch: the PyTorch/CUDA port of gatk_tpu for NVIDIA Hopper GPUs.

The port grows slice by slice beside gatk_tpu, which stays the reference. This
slice is HaplotypeCaller, BAM to VCF: host stages (read filtering, activity
profile, read-threading assembly, genotyping, VCF writing) are copies of
gatk_tpu's numpy/C++ modules, and the device stage, the PairHMM read x
haplotype likelihoods, runs as a hand-written CUDA kernel (csrc/pairhmm_fwd.cu)
with a plain PyTorch version beside it (ops/pairhmm.py).

The package imports torch and never jax or gatk_tpu. Its entry points run on
the first CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
