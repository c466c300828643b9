"""The plain reference that decides `correct`: NumPy only.

It imports neither JAX, nor the JAX package, nor anything of the port. It
rebuilds the basis gate from the configuration's parameters, reads the
coverage set's pickle as a raw file into stand-in classes of its own, and
judges the program's outputs (depths, parameters, certificates) against
what it works out itself.
"""
