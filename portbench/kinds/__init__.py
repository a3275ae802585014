"""Kinds of unit a traffic mix drives, one module each, named by the
mix's ``kind``. A kind module defines:

- ``setup(ctx) -> state``: make the cell's inputs from ``ctx.seed``, build
  what the program builds before its users' requests arrive, and warm up
  every shape the window uses;
- ``unit(ctx, state, i)``: the i-th unit of the closed loop, through the
  program's own entry points; it adds its work to ``ctx.work``, the
  program's stage seconds to ``ctx.stages``, counts outputs that never
  came or name the wrong frame to ``ctx.failed``, and offers its outputs
  to ``ctx.sample``;
- ``release(state)``: drop the program's device state;
- ``check(ctx, state) -> {number: value}``: judge the sampled outputs
  against ``portbench/reference`` (nothing of the program);
- ``control(ctx, state) -> {number: value}``: the same numbers with the
  reference computed a precision below the configuration's in the
  program's place (``control.py``; the benchmark's runs never call it).
"""
