"""The plain float32 reference the benchmark holds the program to, and the
functions that count its operations and bytes.  Imports nothing of the
measured program and no JAX."""
