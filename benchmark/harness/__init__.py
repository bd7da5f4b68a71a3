"""The benchmark's own code: traffic and database generation, the stream
window, the trace reduction, the plain reference and the comparison.

Of the program, only `dbcache` imports anything (its public writers, to
build a configuration's database once); `run.py` takes `Aligner`. The
plain reference (`reference`) imports neither the program nor JAX."""
