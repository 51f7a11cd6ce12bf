"""The benchmark's harness: finding a cell's files by name, the scene and
weight generators, the run context the metric readers read, device traces
and the bound arithmetic. It imports the program under test only in the
drivers, which take from it the entry points, their spans and counters and
kernel names."""
