"""K3, ``csrc/traceback.cu``: the walk back through K2's direction
planes, launched by ``traceback_launch``.  Timed only (its work is a
walk of a few hundred moves; no roofline share is read)."""

LAUNCHER = "traceback_launch"
