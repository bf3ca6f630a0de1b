"""Launchers of the LM stack: the serve entry point."""
