"""Spec, state, action decoding and physics of the port."""
