"""Scope: hierarchical name -> value store of torch tensors.

Port of ``paddle_tpu/core/scope.py`` (reference: paddle/fluid/framework/
scope.h:48). Values are ``torch.Tensor``s on the executor's device, so
persistable state stays resident on the card between ``Executor.run``
calls; host numpy arrays a caller sets are moved to the device when a run
reads them.
"""


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent
        self.kids = []

    def var(self, name):
        """Find-or-create in THIS scope (reference: scope.h Var())."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return name
            s = s.parent
        return None

    def has(self, name):
        return self.find_var(name) is not None

    def get(self, name, default=None):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return default

    def set(self, name, value):
        # Write where the var lives, else create locally.
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s.parent
        self._vars[name] = value

    def erase(self, name):
        self._vars.pop(name, None)

    def local_var_names(self):
        return list(self._vars)

    def new_scope(self):
        kid = Scope(parent=self)
        self.kids.append(kid)
        return kid

    def drop_kids(self):
        self.kids = []
