"""Evaluation metrics of the port (``metrics.py``: FID, PSNR, SSIM, the
LPIPS aggregation) and the LPIPS backbones (``lpips.py``)."""
