"""Serving over several cards: the data-parallel CNN mesh (``cnn_mesh``)."""
