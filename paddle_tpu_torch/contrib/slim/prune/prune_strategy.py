"""Pruning strategy (reference:
python/paddle/fluid/contrib/slim/prune/prune_strategy.py
SensitivePruneStrategy — epoch-scheduled pruning with a
sensitivity-driven rate)."""

from paddle_tpu_torch.inference.freeze import host_array

__all__ = ["SensitivePruneStrategy"]


class SensitivePruneStrategy:
    """Applies the pruner to every graph parameter between start_epoch
    and end_epoch, ramping the prune rate by delta_rate per epoch
    (the schedule of the reference; the per-layer sensitivity analysis
    feeds ``sensitivities`` as name->max-ratio caps)."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=10,
                 delta_rate=0.20, acc_loss_threshold=0.2,
                 sensitivities=None):
        self.pruner = pruner
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.delta_rate = delta_rate
        self.acc_loss_threshold = acc_loss_threshold
        self.sensitivities = sensitivities or {}

    def on_compress_begin(self, context):
        pass

    def on_epoch_begin(self, context):
        pass

    def on_batch_begin(self, context):
        pass

    def on_batch_end(self, context):
        pass

    def on_epoch_end(self, context):
        if context.epoch_id < self.start_epoch or \
                context.epoch_id > self.end_epoch or self.pruner is None:
            return
        steps = context.epoch_id - self.start_epoch + 1
        rate = min(self.delta_rate * steps, 1.0)
        scope = context.scope
        if scope is None or context.graph is None:
            return
        for p in context.graph.all_parameters():
            cap = self.sensitivities.get(p.name)
            r = min(rate, cap) if cap is not None else rate
            val = scope.get(p.name)
            if val is None:
                continue
            if hasattr(self.pruner, "ratios"):
                pruned = self.pruner.prune(host_array(val), ratio=r)
            else:
                pruned = self.pruner.prune(host_array(val))
            scope.set(p.name, pruned)

    def on_compress_end(self, context):
        pass
