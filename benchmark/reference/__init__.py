"""The plain reference of the benchmark: a frozen copy of the plain
PyTorch path of mrhash_tpu_torch's frame step (params, the map state, the
hash table, coordinates, the camera, allocation, compaction, the kernels'
twins K1, K2, K3, coarsening, starvation, GC and the pipeline), taken at
the commit that introduced the benchmark.  It imports nothing of the
program, runs every kernel as its plain twin on whatever device it is
given, and is never edited by a change to the program: a later change
that alters the map the program builds shows against it.
"""
