"""Hand-written CUDA kernels of the port: K1 (fused CFTM branch) and K2
(fused phase-plane tail), their plain versions, and the nvcc/ctypes build."""
