"""Copies of the reference's pure-Python scheduler pieces the port needs."""
