"""One tick of decoding, captured once as a CUDA graph and replayed.

The PyTorch counterpart of the one compiled program that
nsa_vibe_tpu/models/tinylm.py builds with `jax.jit` + `lax.scan`
(`_generate_scan_fn`, `_generate_ragged_fn`): there a scan body is one
decode step, its sampling and its bookkeeping, dispatched once for the
whole generation. Eagerly, one m7c decode step issues ~4000 PyTorch ops,
and the host's dispatch of them, not the card, sets the step's time. A
replay of a captured graph issues the same kernels with one host call.

`tick()` issues one tick's work on the current stream. It must read and
write only tensors that outlive the graph (the parameters, and `state`,
which it updates in place: caches, token buffers, counters), read no
device value on the host and branch on none: the ragged step
(core/decode.py::nsa_decode_step_ragged, cache t on the device) and
utils/sampling.py::sample_logits are written so. The uniform step, whose
position is a host int, cannot be captured: a graph of it would replay one
position forever.

Capture follows PyTorch's recipe: one warm-up tick on a side stream (it
builds and loads the kernels, ops/cuda/build.py, and sets up cuBLAS), after
which `state` and the generator's state are put back, so that capture
leaves every tensor as it found it; then `torch.cuda.graph` records one
tick. Memory the tick allocates while captured (activations, the decode
workspace of ops/cuda/sel_attn.py) comes from the graph's private pool and
stays reserved for its replays. A sampling `torch.Generator` is registered
with the graph (`CUDAGraph.register_generator_state`), so each replay draws
fresh numbers and a seed reproduces them; a torch without that method
raises for sampled decoding, and greedy decoding needs none.

A graph is tied to the tensors it was captured on: it is never replayed
against other ones. The generate functions (models/tinylm.py) capture a
new graph per call and drop it at the end; admission (core/cache.py::
admit_row) writes into the captured caches in place. On CPU tensors there
is nothing to capture: `replay()` runs `tick()` eagerly. No fallback hides
the card: on CUDA a failed capture or replay raises.

Launch counts: the kernel wrappers (ops/cuda) count the launches they make
when they run, and capture calls them once more without running anything.
A replay calls no wrapper, so its launches are read from a profiler trace
(chip_smoke.py phase (g)), not from the wrappers' counts.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch


class DecodeGraph:
    """tick() captured on `state`'s device (or run eagerly on the CPU).

    state: every tensor tick() writes; generator: the torch.Generator its
    sampling draws from, if any (on the same device)."""

    def __init__(self, tick: Callable[[], None], state: List[torch.Tensor],
                 generator: Optional[torch.Generator] = None):
        self.tick = tick
        self.graph = None
        dev = state[0].device
        if dev.type == "cpu":
            return
        if generator is not None and not hasattr(torch.cuda.CUDAGraph,
                                                 "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state): sampled decoding on the card needs it; "
                "greedy decoding (no generator) does not")
        stream = torch.cuda.current_stream(dev)
        snap = [s.clone() for s in state]
        rng = generator.get_state() if generator is not None else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            tick()                                   # warm-up
            torch._foreach_copy_(state, snap)        # capture starts from the same state
        stream.wait_stream(side)
        del snap
        if generator is not None:
            generator.set_state(rng)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph):
            tick()

    def replay(self) -> None:
        """One tick: the graph's replay, or tick() on the CPU."""
        if self.graph is None:
            self.tick()
        else:
            self.graph.replay()
