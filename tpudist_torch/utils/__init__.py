"""Host utilities of the port (counterpart of :mod:`tpudist.utils`)."""
