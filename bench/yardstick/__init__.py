"""The frozen yardstick: peaks, work formulas, the kernel-class
classifier and the reduction of a profiler trace to intervals. Copied
here, never imported from the program, so that a change to the program
cannot move it."""
