"""One run of one cell: set-up, the timed window, and what the comparison
and the metrics read afterwards.

The window drives the engine's block as its Driver runs it, without
files: `sweep.run_block(Sweeper(system), state, steps)` and then
`sweep.stats_to_numpy(stats)`, the block's one read-back.  It runs whole
blocks and ends at the first block boundary after `seconds`.  Set-up is
everything before it: imports, CUDA start-up, the kernels' library (built
by the program into its checkout on the first run), `make_system`, the
start and one warm-up block.

The start is made by the benchmark from the seed, on the device: each
walker's particles on the simple hypercubic lattice of the box (n^dim
sites, the first N taken), each coordinate displaced by a uniform
fraction JITTER of the spacing, every bead at the same place.
The program's generators are seeded with the same seed; its
`init_state` takes the start as a host array, so it is copied there once."""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from . import manifest
from .capture import Capture
from .counting import bead_updates_per_step, rate

PORT = "pathintegralgroundstate_torch"
# the start's displacement of each coordinate, in lattice spacings
JITTER = 0.1


def port_modules() -> SimpleNamespace:
    """The program's modules the window drives."""
    imp = importlib.import_module
    return SimpleNamespace(
        config=imp(f"{PORT}.config"), system=imp(f"{PORT}.system"),
        state=imp(f"{PORT}.state"), sweep=imp(f"{PORT}.sweep"),
        moves=imp(f"{PORT}.ops.moves"), kernels=imp(f"{PORT}.ops.kernels"),
        pairwise=imp(f"{PORT}.ops.pairwise"),
        bisection=imp(f"{PORT}.ops.bisection"), worm=imp(f"{PORT}.ops.worm"),
        cascade=imp(f"{PORT}.ops.cascade"), build=imp(f"{PORT}.utils.build"))


def sim_fields(workload: dict, config: dict) -> dict:
    """The configuration as the cell runs it: the configuration's fields,
    the cell's overrides and its walker count."""
    fields = {**config["fields"], **workload.get("overrides", {}),
              "n_walkers": workload["walkers"]}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in fields.items()}


def start_positions(fields: dict, seed: int, jitter: float, device,
                    dtype) -> torch.Tensor:
    """[W, N, D]: the lattice start, displaced per walker from the seed."""
    W, N, D = fields["n_walkers"], fields["Np"], fields["dim"]
    L = (N / fields["density"]) ** (1.0 / D)
    n = 1
    while n ** D < N:
        n += 1
    a = L / n
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float64)] * D, indexing="ij"), -1)
    sites = ((grid.reshape(-1, D)[:N] + 0.5) * a - 0.5 * L).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2 ** 63 - 1))
    u = torch.rand((W, N, D), generator=gen, device=device,
                   dtype=torch.float64)
    return (sites + jitter * a * (2.0 * u - 1.0)).to(dtype)


@dataclass
class Run:
    cell: str
    fields: dict
    workload: dict
    seed: int
    device: str
    setup_s: float = 0.0
    window_s: float = 0.0
    blocks: int = 0
    steps: int = 0
    per_step: int = 0
    peak_bytes: int = 0
    capture: Capture = None
    trace: object = None          # trace.TraceData of a --trace 1 run
    final_paths: torch.Tensor = None   # the state the window ends on
    final_isopen: torch.Tensor = None
    reference: tuple = None       # the float64 reference's measurement

    @property
    def walkers(self) -> int:
        return self.fields["n_walkers"]

    @property
    def bead_updates_per_s(self) -> float:
        return rate(self.walkers, self.per_step, self.steps, self.window_s)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None, workload: dict = None,
             config: dict = None, port=None) -> Run:
    """One run of the cell.  t0: the process's start on the
    time.perf_counter clock (default: now)."""
    t0 = time.perf_counter() if t0 is None else t0
    workload = workload or manifest.workload(cell)
    config = config or manifest.config(workload["config"])
    port = port or port_modules()
    fields = sim_fields(workload, config)
    run = Run(cell=cell, fields=fields, workload=workload, seed=seed,
              device=device, per_step=bead_updates_per_step(fields))
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = port.config.SimConfig(**fields)
    system = port.system.make_system(cfg, device)
    start = start_positions(fields, seed, JITTER, device, system.dtype)
    # the program's init_state takes host positions (numpy)
    state = port.state.init_state(system, seed, start.cpu())
    del start
    sweeper = port.sweep.Sweeper(system)
    nsteps = workload["steps_per_block"]
    rng = np.random.default_rng(seed)
    cap = Capture(port, sweeper, fields["n_walkers"], rng, device)
    run.capture = cap

    def block(st):
        st, stats = port.sweep.run_block(sweeper, st, nsteps)
        port.sweep.stats_to_numpy(stats)
        return st

    cap.install()
    try:
        state = block(state)                   # the warm-up block
        cap.end_warmup()
        sync()
        run.setup_s = time.perf_counter() - t0
        w0 = time.perf_counter()
        while True:
            cap.begin_block(nsteps)
            if trace and run.trace is None:
                from .trace import profiled
                lib = port.build.kernels() if cuda else None
                state, run.trace = profiled(lambda: block(state), sync,
                                            nsteps, lib)
            else:
                state = block(state)
            run.blocks += 1
            if time.perf_counter() - w0 >= seconds:
                break
        sync()
        run.window_s = time.perf_counter() - w0
    finally:
        cap.uninstall()
        cap.sweeper = None
    run.steps = run.blocks * nsteps
    if cuda:   # over set-up and window, before anything is compared
        run.peak_bytes = torch.cuda.max_memory_allocated()
    run.final_paths, run.final_isopen = state.paths, state.isopen
    del sweeper, system, state
    return run
