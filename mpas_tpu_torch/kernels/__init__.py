"""Hand-written CUDA kernels of the port (sources in ../csrc).

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; it raises on anything else. Every launch
adds one to `launch_counts[name]`, so a run can show which kernels its
path went through. Each kernel runs one block per tile of consecutive
columns or cells; `fit_tile` sizes a tile to a shared-memory budget.
"""

launch_counts = {"acoustic_cell_update": 0, "tinydot": 0, "vmix_solve": 0}

SMEM_LIMIT = 232_448   # shared memory a block may use on the H100
MAX_THREADS = 256      # the kernels' __launch_bounds__(256)


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def fit_tile(name: str, smem_of, budget: int, max_cols: int):
    """(cols, smem bytes) of a kernel's tile: the most columns (or cells)
    up to `max_cols`, a multiple of 8 where above 8, whose shared memory
    `smem_of(cols)` fits `budget`, shrinking down to one; raises ValueError
    where one does not fit a block."""
    cols = max_cols if max_cols <= 8 else max_cols // 8 * 8
    while cols > 8 and smem_of(cols) > budget:
        cols -= 8
    while cols > 1 and smem_of(cols) > budget:
        cols -= 1
    smem = smem_of(cols)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: one tile column needs {smem} bytes of "
                         f"shared memory, more than a block has "
                         f"({SMEM_LIMIT})")
    return cols, smem
