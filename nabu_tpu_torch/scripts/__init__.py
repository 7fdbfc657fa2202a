"""Pipeline scripts of the port: `data` and `train`."""
