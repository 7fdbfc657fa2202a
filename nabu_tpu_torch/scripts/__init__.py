"""Pipeline scripts of the port: `data`, `train`, `test`, `decode` and `recognize`."""
