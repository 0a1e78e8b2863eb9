"""Traffic drivers, one module per kind of traffic, named by a mix's ``driver``."""
