"""Cells whose CPU tests live in a file of their own.

``tests/tiny.py`` holds the tiny sizes of the cells that the benchmark's
generic tests (``test_portbench_cells.py``, ``test_portbench_control.py``,
``test_portbench_faults.py``) were written for, and those tests take
their cells from ``tiny.cells()``. A cell added later brings its tiny size
and its tests in new files (the benchmark's existing files stay as they
are): its size is registered here, and ``tiny.cells()`` leaves it to its
own file.
"""

from portbench.tests import tiny

OWN_TESTS = {
    # portbench/tests/test_portbench_view.py
    "gs-view": ("gs-view-1080p", {"gaussians": 6000, "depth": 6, "bucket": 256,
                                  "width": 88, "height": 56}),
}

for _cell, (_config, _size) in OWN_TESTS.items():
    tiny.SIZES[_config] = _size

_all_cells = tiny.cells
tiny.cells = lambda: [c for c in _all_cells() if c not in OWN_TESTS]
