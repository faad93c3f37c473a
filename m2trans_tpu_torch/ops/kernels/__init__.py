"""Hand-written CUDA kernels of the port: K1 / K1b (fused CFTM branch and
its VJP) and K1n (the bare branch) in ``halo_attn``, K2 / K2b (fused
phase-plane tail and its VJP) in ``tail_band``, K3 (fused feed-forward conv)
in ``ff_conv``, K4 (lane relayouts) in ``relayout``, each with its plain
version, the train step's device marks (empty named kernels) in ``marks``,
and the nvcc/ctypes build."""
