"""Test order: the port's longest test files go to the workers first.

The tier-1 run (``-p xdist --dist loadfile``) hands whole files to its
workers.  xdist orders the files by their number of tests, most first, so
a file of one long test went to a worker last and set the run's end.  A
file of the port's tests that takes more than about 250 s of that run
declares itself with ``pytestmark = pytest.mark.long``.  Here xdist's own
reordering is turned off and the collection is sorted stably instead: the
long files first, then the others by their number of tests, most first, as
xdist would have sent them.  Which tests run is unchanged.
"""

import collections

import pytest


def _file(item: pytest.Item) -> str:
    return item.nodeid.split("::", 1)[0]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "long: a file of the port's tests that takes more than about 250 s of the "
        "tier-1 run; its tests go to the workers first (the repo's root conftest.py)")
    if hasattr(config.option, "loadscopereorder"):  # xdist is loaded
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(items):
    per_file = collections.Counter(_file(item) for item in items)
    items.sort(key=lambda item: (item.get_closest_marker("long") is None,
                                 -per_file[_file(item)]))
