"""What holds a dry-run cell's peak: the cell of ``launch/dryrun.py`` at a
cut depth on the single mesh (256 fake ranks), its peak of live storage and
the storages alive at that peak, summed by the op that made them and its
local shape; with ``--ablate``, the same with each of the mesh repairs
below switched back to the code it replaced, one at a time and then all.

  PYTHONPATH=src python -m repro_torch.launch.peak --arch mistral_large_123b \
      --shape train_4k --layers 2 --ablate [--top 8]

The repairs (``REPAIRS``), each switched off by putting the earlier code
back for the run:

* ``vocab_logprob``: the label log-prob on the rank's vocabulary shard
  (``transformer._vocab_parallel_logprob``); off, ``log_softmax`` and
  ``gather`` on the split logits, which DTensor runs on the whole vocab.
* ``grad_constraint``: ``layers.shard_act``'s gradient redistributed to the
  constrained spec (``_Constrain``); off, the forward redistribute alone.
* ``reduce_partial``: a ``Partial`` input of ``rms_norm`` reduced first
  (``layers.reduce_partial``); off, passed on.
* ``merge_heads``: the out-projection's input split as its rows
  (``attention._MergeHeads``); off, a plain reshape.

The run is one step of the cell on fake tensors, as the dry run's, twice:
the first finds the peak, the second stops its account when the live
bytes first reach it. Host CPU only; no card.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from dataclasses import replace
from unittest import mock

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.sharding import rules_for_cfg
from repro_torch.launch.dryrun import attn_block, build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, layers, transformer
from repro_torch.models.transformer import LM
from repro_torch.telemetry import roofline

GIB = 2 ** 30


def _replicated_logprob(x, head, labels):
    logits = layers.shard_act(x @ head.T, ("act_batch", "act_seq", "act_vocab"))
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, labels[..., None])[..., 0]


def _reshaped_heads(t, w):
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])


class _Unconstrained:
    @staticmethod
    def apply(x, spec):
        return layers._constrain(x, spec)


REPAIRS = {
    "vocab_logprob": lambda: mock.patch.object(transformer, "_label_logprob",
                                               _replicated_logprob),
    "grad_constraint": lambda: mock.patch.object(layers, "_Constrain", _Unconstrained),
    "reduce_partial": lambda: mock.patch.object(layers, "reduce_partial", lambda x: x),
    "merge_heads": lambda: mock.patch.object(attention, "_merge_heads", _reshaped_heads),
}


class PeakCounter(roofline.MemoryCounter):
    """:class:`roofline.MemoryCounter` that knows the op and local shape
    that made each storage and, given the peak ``target``, keeps the
    storages alive when the live bytes first reach it (:attr:`at_peak`)."""

    def __init__(self, args=(), target: int = 0):
        self._made = {}
        self.target, self.at_peak = target, None
        super().__init__(args)

    def op(self, func, args, kwargs, out):
        for t in roofline._tensors(out):
            for st in roofline._storages(t):
                self._made.setdefault(st._cdata, (func._opname, tuple(t.shape), str(t.dtype)))
        super().op(func, args, kwargs, out)
        if self.at_peak is None and self.target and self.current >= self.target:
            self.at_peak = self._live()

    def _free(self, key):
        self._made.pop(key, None)
        super()._free(key)

    def _live(self):
        sums, seen = {}, set()
        for key, group in self._groups.items():
            if id(group) in seen:
                continue
            seen.add(id(group))
            made = self._made.get(key, ("argument", None, None))
            n, b = sums.get(made, (0, 0))
            sums[made] = (n + 1, b + group[0])
        return sorted(sums.items(), key=lambda kv: -kv[1][1])


def run(arch: str, shape_name: str, layers_: int, off=(), top: int = 8):
    """(peak bytes, the storages at the peak by maker) of one step of the
    cut cell with the repairs ``off`` switched off; prints both."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = SHAPES[shape_name]
    cfg = replace(get_config(arch), num_layers=layers_)
    mesh = make_production_mesh(multi_pod=False)
    rules = rules_for_cfg(shape.mode, cfg)
    target, live = 0, None
    with contextlib.ExitStack() as stack:
        for name in off:
            stack.enter_context(REPAIRS[name]())
        for _ in range(2):
            with FakeTensorMode():
                model = LM(cfg, device="cpu", attn_block=attn_block(shape))
                fn, args, _, _ = build_cell(cfg, shape, mesh, rules, model=model)
                counter = PeakCounter(args, target)
                with counter:
                    fn(*args)
            target, live = counter.peak, counter.at_peak
    label = ", ".join(off) if off else "none"
    print(f"[peak] {arch} x {shape_name}, {layers_} layers, repairs off: {label}: "
          f"peak {target / GIB:.2f} GiB; alive at the peak, by the op that made them:")
    for (opname, shp, dtype), (n, b) in live[:top]:
        print(f"[peak]   {b / GIB:8.2f} GiB  {n:4d} x {opname} {shp} {dtype}")
    return target, live


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--off", action="append", default=[], choices=list(REPAIRS))
    ap.add_argument("--ablate", action="store_true",
                    help="every repair off alone, then all of them, after the run as it is")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        runs = [args.off]
        if args.ablate:
            runs = [[]] + [[n] for n in REPAIRS] + [list(REPAIRS)]
        peaks = [(", ".join(off) or "none", run(args.arch, args.shape, args.layers, off,
                                                  args.top)[0]) for off in runs]
    finally:
        dist.destroy_process_group()
    for label, peak in peaks:
        print(f"[peak] off: {label:70s} {peak / GIB:8.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
