"""Process-level runtime choices of the port: the device, the NaN
sanitiser, and one dispatch a program (``CapturedCall``).

Of ``timetuning_tpu/runtime.py`` only ``enable_debug_nans`` has a meaning
here; the rest there is JAX platform and compilation-cache setup. Its
counterpart of a ``jax.jit`` program is ``CapturedCall``: a CUDA graph per
input shape, captured once and replayed by one launch.
"""

from __future__ import annotations

import dataclasses


def resolve_device(device: str | None):
    """``device`` when given; else the card, and an error where there is
    none: the port never takes the CPU without being asked to."""
    import torch

    if device:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found (torch.cuda.is_available() is false) and no "
            "device given; pass --device cpu (device='cpu') to run on the host")
    return torch.device("cuda")


def enable_debug_nans(flag: bool) -> None:
    """Numerical sanitiser behind a flag: autograd's anomaly mode, which
    raises at the backward op that produced a NaN (the reference enabled it
    globally with ``np.seterr(all='raise')``, time_tuning.py:523-524)."""
    import torch

    torch.autograd.set_detect_anomaly(bool(flag))


@dataclasses.dataclass
class _Graph:
    """One key's program: after its eager call, the graph, the static input
    buffers it reads, the static outputs it writes and the kernel launches
    one replay makes."""

    warm: bool = False
    graph: object = None
    static: list = dataclasses.field(default_factory=list)
    out: object = None
    launches: dict = dataclasses.field(default_factory=dict)


class CapturedCall:
    """``fn(*args)`` as one CUDA graph per input shape, replayed by one
    launch: the port's counterpart of a ``jax.jit`` program.

    * The key of a graph is the shape, stride, dtype and device of every
      tensor in ``args`` (nested tuples, lists and dicts) plus the caller's
      ``key`` (``jit``'s retrace rule). Whatever else ``fn`` reads that can
      change the work (a flag, a state tensor's address) belongs in ``key``:
      ``fn`` runs only while a graph is captured, so its other arguments and
      the tensors it reaches by closure are read at capture only.
    * The first call of a key runs ``fn`` eagerly on a side stream (lazy
      initialisation, such as cuBLAS handles, cached constants and the
      optimizer's moments, happens there): a real call, whose results are
      returned. The next call copies
      its tensors into static buffers, captures ``fn`` on them (capturing
      runs no kernel), replays the graph, which does that call's work, and
      returns the static outputs. Every later call copies its tensors into
      the static buffers (``copy_`` on the current stream, so after any
      event the caller's stream already waits on) and replays.
    * The outputs of a replay stay valid until the next call of this
      ``CapturedCall``: the graphs of all its keys share one memory pool, so
      a replay of any of them may reuse another's output memory. A caller
      that keeps them longer clones them.
    * Kernel launches and the work counts beside them (``ops/kernel_lib``'s
      ``counts()``, raised on the host when a wrapper launches) are counted
      as eager calls count them: the counts a capture raised are taken back
      out, kept with the graph, and added on every replay.
    * A capture that fails raises. Nothing falls back to the eager path.
    * While a profiler runs, each call is a span (``obs/profiling``):
      ``graph.eager``, ``graph.capture`` (then ``graph.replay``) on a key's
      first two calls, ``graph.replay`` (the static copies, the replay, the
      counts) on every later one.

    Stays eager, by this one rule: CPU tensors (there is no CUDA graph on
    the host; ``fn`` is called directly) and a ``group`` (a process group
    that ``fn``'s collectives run over: gloo's all-reduce of a CUDA tensor is
    a round trip through the host, which a graph cannot hold; NCCL across
    cards is not captured either, for want of a machine with more than one
    card to check it on)."""

    def __init__(self, fn, group=None):
        self.fn, self.group = fn, group
        self._graphs: dict = {}
        self._pool = None
        self._stream = None

    def __call__(self, *args, key=()):
        import torch
        from torch.utils import _pytree as pytree

        from timetuning_tpu_torch.obs.profiling import annotate
        from timetuning_tpu_torch.ops import kernel_lib

        leaves, spec = pytree.tree_flatten(args)
        where = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
        on_card = [leaves[i].is_cuda for i in where]
        if self.group is not None or not any(on_card):
            return self.fn(*args)
        if not all(on_card):
            raise ValueError("CapturedCall: tensors on the card and on the host in "
                             "one call; put every input on the card")
        dev = leaves[where[0]].device
        k = (key, tuple((tuple(leaves[i].shape), leaves[i].stride(), leaves[i].dtype,
                         leaves[i].device) for i in where))
        entry = self._graphs.setdefault(k, _Graph())
        if entry.graph is None:
            if not entry.warm:
                entry.warm = True
                with annotate("graph.eager"):
                    return self._eager(args, dev)
            with annotate("graph.capture"):
                self._capture(entry, leaves, spec, where, dev)
        with annotate("graph.replay"):
            for s, i in zip(entry.static, where):
                s.copy_(leaves[i], non_blocking=True)
            entry.graph.replay()
            kernel_lib.add_counts(entry.launches)
        return entry.out

    def _eager(self, args, dev):
        import torch

        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = self.fn(*args)
        current.wait_stream(self._stream)
        return out

    def _capture(self, entry: _Graph, leaves, spec, where, dev) -> None:
        import torch
        from torch.utils import _pytree as pytree

        from timetuning_tpu_torch.ops import kernel_lib

        static = [torch.empty_like(leaves[i]) for i in where]
        leaves = list(leaves)
        for s, i in zip(static, where):
            leaves[i] = s
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = kernel_lib.counts()
        try:
            # on the warm-up call's stream; thread_local: the loader's threads
            # may call the CUDA runtime while the main thread captures
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = self.fn(*pytree.tree_unflatten(leaves, spec))
        finally:
            after = kernel_lib.counts()
            kernel_lib.add_counts({name: n - after[name] for name, n in before.items()})
        entry.graph, entry.static, entry.out = graph, static, out
        entry.launches = {name: after[name] - n for name, n in before.items()
                          if after[name] != n}
