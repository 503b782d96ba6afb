"""gatk_tpu_torch: the PyTorch/CUDA port of gatk_tpu for NVIDIA Hopper GPUs.

The port grows slice by slice beside gatk_tpu, which stays the reference. Its
slices are HaplotypeCaller (BAM to VCF or GVCF), Mutect2 with its filtering
tools, and the germline and somatic CNV tools. Host stages are copies of
gatk_tpu's numpy/C++ modules; the device stages are PyTorch, with the PairHMM
(csrc/pairhmm_fwd.cu, csrc/pairhmm_matrix.cu) and the copy-number HMM's
forward-backward pass (csrc/cnv_hmm.cu) as hand-written CUDA kernels, each
with a plain PyTorch version beside it (ops/pairhmm.py, ops/cnv_hmm.py).

The package imports torch and never jax or gatk_tpu. Its entry points run on
the first CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
