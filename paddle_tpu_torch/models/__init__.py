"""Model definitions built on the port's layers."""
