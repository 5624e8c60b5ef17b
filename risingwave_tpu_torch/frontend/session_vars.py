"""Session variables: one SET/SHOW implementation for both sessions.

Reference parity: src/common/src/session_config/ — typed knobs with
defaults, SET <name> = <value> | TO DEFAULT, SHOW <name>, SHOW ALL.
Typed (integer) knobs bind to attributes on the owning session so
future CREATE statements read them; free-form vars stay strings.

Copied from ``risingwave_tpu/frontend/session_vars.py`` unchanged but
for its imports (pure Python: the port keeps its own copy).
"""

from __future__ import annotations

from typing import Dict, Optional


class SessionVars:
    """Owner-attached variable surface shared by Frontend and
    DistFrontend (their SET semantics must not drift)."""

    def __init__(self, owner, attr_map: Dict[str, str],
                 string_defaults: Optional[Dict[str, str]] = None,
                 validators: Optional[Dict[str, object]] = None):
        self.owner = owner
        self.attr_map = dict(attr_map)           # name → owner attr
        self.defaults = {n: getattr(owner, a)
                         for n, a in self.attr_map.items()}
        self.strings = dict(string_defaults or {})
        self._string_vals: Dict[str, str] = {}
        # name → callable(value) raising PlanError on a bad value —
        # SET-time validation for free-form string vars (e.g.
        # stream_rewrite_rules rejects unknown rule names)
        self.validators = dict(validators or {})

    def names(self):
        return sorted(set(self.attr_map) | set(self.strings))

    def known(self, name: str) -> bool:
        return name in self.attr_map or name in self.strings

    @staticmethod
    def _display(v) -> str:
        return "" if v is None else str(v)

    def get(self, name: str) -> str:
        if name in self.attr_map:
            return self._display(getattr(self.owner,
                                         self.attr_map[name]))
        return self._display(self._string_vals.get(
            name, self.strings[name]))

    def show_all(self):
        return [(n, self.get(n)) for n in self.names()]

    def set(self, name: str, value) -> None:
        """value=None means TO DEFAULT."""
        from risingwave_tpu_torch.frontend.planner import PlanError
        if name in self.attr_map:
            if value is None:
                value = self.defaults[name]
            elif not isinstance(value, int) or isinstance(value, bool):
                raise PlanError(f"{name} must be an integer")
            setattr(self.owner, self.attr_map[name], value)
        elif name in self.strings:
            if value is None:
                self._string_vals.pop(name, None)
            else:
                check = self.validators.get(name)
                if check is not None:
                    check(str(value))
                self._string_vals[name] = str(value)
        else:
            raise PlanError(
                f"unrecognized configuration parameter {name!r}")
