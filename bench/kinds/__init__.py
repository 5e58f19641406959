"""What depends on the kind of a configuration, one module a kind:
``bench/kinds/<kind>.py`` for a config whose ``"kind"`` is ``<kind>``,
found by that name under the root the manifest was read from.

A kind module holds ``NUMBERS``, the names of the numbers its comparison
yields (the keys ``bench/limits/<cell>.json`` may hold), and
``setup(cell, seed, devices, lap)``, which makes the run's inputs from the
seed, builds the program as its users' entry point builds it, runs call 0
(the call the reference replays) and returns the run. ``lap(name)`` marks
the end of a phase of set-up. The run has:

- ``call(on_round=None)``: one call of the window, on the next call's draws;
- ``rounds_per_call``, ``evals_per_call`` and ``gossip_per_call``;
- ``trainer``, ``inputs`` and ``param_count``, which the per-layer readers
  read;
- ``release()``: drops the program's state, before the reference runs;
- ``compare(device)``: replays call 0 with the plain reference and returns
  each of ``NUMBERS`` by name.
"""
