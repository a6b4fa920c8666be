"""Image quality metrics: the counterpart of ``hvi_cidnet_tpu/metrics``.

PSNR, SSIM, NIQE and BRISQUE are host-side float64 numpy and scipy, as in
the JAX package (bit fidelity with the reference's scoring over speed);
LPIPS is an ``nn.Module`` that runs on the card. Nothing here imports cv2
or PIL: what the JAX package computes with cv2 is computed in numpy, and
``pil_resize`` is Pillow's resize.
"""
