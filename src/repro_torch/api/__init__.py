"""Peer-protocol API of the serve plane: keys, messages, transport, driver."""
