"""Classification layers of the port: `confusion.py`, copied from the JAX
package, and `annotate.py`, the pivot annotation of exp4's per-k path and
exp6's read voting.  The JAX package's `classify/__init__.py` re-exports
both; the port's drivers import the modules directly, so nothing is
re-exported here."""
