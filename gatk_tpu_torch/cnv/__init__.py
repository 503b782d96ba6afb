"""Copy-number variation stack of the port (gatk_tpu/cnv/ on PyTorch).

The readers, the ploidy model and the somatic host code are copies of
gatk_tpu's; the device programs are PyTorch: the gCNV denoising model
(denoising.py: autograd ADAM, and the copy-number HMM's forward-backward pass
as a hand-written CUDA kernel, ops/cnv_hmm.py), ModelSegments' slice-sampling
chains (mcmc.py) and the panel of normals' SVD (somatic.build_panel_of_normals).
"""
