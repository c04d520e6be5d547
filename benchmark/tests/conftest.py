"""The tiny sizes (``_tiny.SIZES``) of the configurations whose scene
generators are newer than that table: the tests that run every cell at a
tiny size on the CPU find them here."""

from benchmark.tests import _tiny

_tiny.SIZES.setdefault("veach_mis", dict(width=40, height=30))
