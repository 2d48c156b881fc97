"""Graph wrappers for the slim compression framework (reference:
python/paddle/fluid/contrib/slim/graph/graph.py ImitationGraph)."""

__all__ = ["ImitationGraph"]


class ImitationGraph:
    """Wraps a Program for the compression strategies (reference:
    slim/graph/graph.py:26)."""

    def __init__(self, program=None):
        from paddle_tpu_torch.framework import default_main_program

        self.program = program if program is not None \
            else default_main_program()

    def all_parameters(self):
        return self.program.all_parameters()
