"""Launchers of the LM stack: serve, train, the production meshes and the
dry-run's host side."""
