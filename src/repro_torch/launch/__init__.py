"""Entry points of the port: the serving launcher and the step makers."""
