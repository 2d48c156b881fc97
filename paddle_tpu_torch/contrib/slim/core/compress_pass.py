"""Model-compression pass driver (reference:
python/paddle/fluid/contrib/slim/core/compress_pass.py — Context:20,
CompressPass:36, and config-driven build_compressor). Strategies receive
epoch/batch callbacks and mutate the graph/scope (pruning, quantization
schedules)."""

__all__ = ["Context", "CompressPass", "build_compressor"]


class Context:
    """Carries the run state to strategy callbacks (reference:
    compress_pass.py:20)."""

    def __init__(self, place=None, scope=None, program_exe=None, graph=None,
                 epoch_id=0, batch_id=0):
        self.place = place
        self.scope = scope
        self.program_exe = program_exe
        self.graph = graph
        self.epoch_id = epoch_id
        self.batch_id = batch_id


class CompressPass:
    """Run registered compression strategies over training epochs
    (reference: compress_pass.py:36 — the strategy callback loop)."""

    def __init__(self, place=None, data_reader=None, data_feeder=None,
                 scope=None, metrics=None, epoch=None, program_exe=None):
        self.place = place
        self.data_reader = data_reader
        self.data_feeder = data_feeder
        self.scope = scope
        self.metrics = metrics
        self.epoch = epoch or 1
        self.program_exe = program_exe
        self.strategies = []

    def add_strategy(self, strategy):
        self.strategies.append(strategy)
        return strategy

    def apply(self, graph):
        """Drive the strategies over `epoch` passes of `data_reader`
        (train steps are the caller's executor runs via program_exe)."""
        context = Context(place=self.place, scope=self.scope,
                          program_exe=self.program_exe, graph=graph)
        for s in self.strategies:
            s.on_compress_begin(context)
        for epoch_id in range(self.epoch):
            context.epoch_id = epoch_id
            for s in self.strategies:
                s.on_epoch_begin(context)
            if self.data_reader is not None:
                for batch_id, data in enumerate(self.data_reader()):
                    context.batch_id = batch_id
                    for s in self.strategies:
                        s.on_batch_begin(context)
                    if self.program_exe is not None and \
                            self.data_feeder is not None:
                        self.program_exe(self.data_feeder.feed(data))
                    for s in self.strategies:
                        s.on_batch_end(context)
            for s in self.strategies:
                s.on_epoch_end(context)
        for s in self.strategies:
            s.on_compress_end(context)
        return context


def build_compressor(place=None, data_reader=None, data_feeder=None,
                     scope=None, metrics=None, epoch=None, config=None):
    """Config-driven CompressPass factory (reference:
    compress_pass.py build_compressor). ``config`` may carry a
    'strategies' list to pre-register."""
    cp = CompressPass(place=place, data_reader=data_reader,
                      data_feeder=data_feeder, scope=scope,
                      metrics=metrics, epoch=epoch)
    for s in (config or {}).get("strategies", []) \
            if isinstance(config, dict) else []:
        cp.add_strategy(s)
    return cp
