"""The port's copy of the native C++ `.nice` codec (`nice_ref.cpp`): the
byte-exact host reference and the host fallback of the port's pipelines."""
