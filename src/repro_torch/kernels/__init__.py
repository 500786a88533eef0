"""Hand-written CUDA kernels for Hopper (``csrc/``), bound with ctypes.

<name>.py — the wrapper, its plain torch version and its launch counter;
ops.py — wrappers with explicit SR entropy; build.py — nvcc at first use;
ref.py — the plain versions under the reference's oracle names.
"""
