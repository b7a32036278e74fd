"""Model code of the port: parameters, layers, decode entry points."""
