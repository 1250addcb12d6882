"""The proqa-torch command line."""
