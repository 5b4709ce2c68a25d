"""Sharding steps 2 and 3 over a list of devices (`mesh.Mesh`)."""
