"""Entry points of the port: the serving launcher."""
