"""Device layer of the port: PyTorch stages and the CUDA kernel wrappers
(the counterpart of svt_hevc_tpu/tpu)."""
