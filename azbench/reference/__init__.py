"""The plain reference that decides ``correct``: the games' rules in NumPy,
one game at a time; the network in float32 PyTorch (with the int8 or int4
tower where a configuration states one), one module a network under
``nets/``; the search one game at a time.
Nothing here imports the program or JAX,
and nothing here takes what the program derived: weights, calibration
scales and draws are worked out again from what the benchmark made.

A game's rules are the module named by its configuration's ``env``
(``reference/<env>.py``, with ``make(rules)``, and ``playouts`` where the
benchmark makes observations of that game), found by name."""

import importlib


def rules_module(cfg: dict):
    return importlib.import_module(f"azbench.reference.{cfg['env']}")


def make_env(cfg: dict):
    """The reference rules of a configuration (its ``env`` and ``rules``)."""
    return rules_module(cfg).make(cfg.get("rules", {}))
