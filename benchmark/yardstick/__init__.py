"""The benchmark's yardstick: the generator of its inputs, the plain PairHMM
and the judgement that decide `correct`, the peaks and the arithmetic of a
roofline, and the run that drives the port through a window. Later changes
to the program do not move it."""
