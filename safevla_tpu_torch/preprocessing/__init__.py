"""Host-side tokenisation and on-device image preprocessing of the port."""
