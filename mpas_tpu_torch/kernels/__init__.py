"""Hand-written CUDA kernels of the port (sources in ../csrc).

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; it raises on anything else. Every launch
adds one to `launch_counts[name]`, so a run can show which kernels its
path went through.
"""

launch_counts = {"acoustic_cell_update": 0, "tinydot": 0}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0
