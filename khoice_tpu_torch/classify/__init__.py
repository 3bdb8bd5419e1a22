"""Classification reports of the port: `confusion.py`, copied from the JAX
package.  The JAX package's `classify/__init__.py` also imports
`annotate.py` (exp6's device annotation, not ported), so nothing is
re-exported here."""
